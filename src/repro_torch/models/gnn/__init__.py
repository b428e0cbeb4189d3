"""The GNN family, the port of ``src/repro/models/gnn``: GAT, SchNet, NequIP
and EquiformerV2 over padded-COO graphs, with their segment ops
(``common.py``) and irrep tables (``irreps.py``)."""
