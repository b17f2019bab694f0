"""The cluster plane's host modules the port's store needs: the journal
(`wal`) and the storage-side edge filter (`pushdown`), copies of the JAX
package's `cluster/wal.py` and `cluster/pushdown.py`.  The services, the
RPC and the consensus are not ported."""
