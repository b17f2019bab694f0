"""The cluster plane, copies of the JAX package's `cluster/` modules:
the RPC (`rpc`), Raft consensus over the journal (`raft`, `wal`), the
metad (`meta_service`, `meta_client`, `repair`, `federation`), the
storaged (`storage_service`, `storage_client`, `pushdown`), the graphd
(`graph_service`, `client`, `dstore`), the HTTP admin (`webservice`),
BALANCE (`balance`), and the in-process `launcher.LocalCluster` and the
standalone `daemons`.  A graphd given a `gpu.GpuRuntime` pins each
space from the storageds' bulk CSR export and serves fused statements
on the card; nothing here imports the JAX package.
"""
