"""The cluster TCK on the port, share 1 of 4: the features of
`test_torch_tck.cluster_share(1)` run against the port's
`LocalCluster(n_meta=1, n_storage=2, n_graph=1,
tpu_runtime=GpuRuntime(device="cpu"))` through
tests/tck/test_tck_cluster.py's own `test_feature_on_cluster` (its
`_ClientEngine` protocol and runner assertions; `[standalone]`
scenarios skipped as it skips them).  The reference's run is that file.
"""
import os

import pytest

from test_torch_tck import cluster_share, cluster_tck

TCK = cluster_tck()
SHARE = cluster_share(1)


@pytest.mark.parametrize("feature", SHARE)
def test_feature_on_the_port_cluster(feature, tmp_path):
    TCK.test_feature_on_cluster(
        os.path.join(TCK._DIR, feature + ".feature"), tmp_path)
