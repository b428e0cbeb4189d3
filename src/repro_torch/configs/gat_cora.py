"""gat-cora [arXiv:1710.10903]: 2 layers, d_hidden=8, 8 heads, attention
aggregation."""
from repro_torch.configs.gnn_common import GNNBundle
from repro_torch.models.gnn import gat


def _make_cfg(spec):
    d = spec.dims
    if spec.name == "molecule":
        return gat.GATConfig(name="gat-cora", n_layers=2, d_hidden=8,
                             n_heads=8, d_feat=0, n_atom_types=100,
                             n_classes=16)
    return gat.GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                         d_feat=d["d_feat"], n_classes=d["n_classes"])


def _flops(cfg, spec):
    d = spec.dims
    N = d.get("n_nodes", 0) * d.get("batch", 1)
    E = d.get("n_edges", 0) * d.get("batch", 1)
    per_layer = 2 * N * cfg.d_feat * cfg.n_heads * cfg.d_hidden \
        + 6 * E * cfg.n_heads * cfg.d_hidden
    return 3.0 * cfg.n_layers * per_layer     # fwd+bwd ~ 3x fwd


def bundle(smoke: bool = False) -> GNNBundle:
    return GNNBundle("gat-cora", gat, _make_cfg, smoke=smoke,
                     flops_fn=_flops)
