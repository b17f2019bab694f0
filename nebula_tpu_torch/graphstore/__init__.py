"""The host storage plane: the schema catalog, the partitioned store and
its journal, the secondary and full-text indexes, the CSR snapshot and
the delta plane — copies of the JAX package's `graphstore` modules."""
