"""schnet [arXiv:1706.08566]: 3 interactions, d_hidden=64, 300 RBF,
cutoff 10."""
from repro_torch.configs.gnn_common import GNNBundle
from repro_torch.models.gnn import schnet


def _make_cfg(spec):
    d = spec.dims
    if spec.name == "molecule":
        return schnet.SchNetConfig(name="schnet", n_interactions=3,
                                   d_hidden=64, n_rbf=300, cutoff=10.0,
                                   task="energy", n_graphs=d["batch"])
    return schnet.SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                               n_rbf=300, cutoff=10.0, d_feat=d["d_feat"],
                               task="node_class", n_classes=d["n_classes"])


def _flops(cfg, spec):
    d = spec.dims
    N = d.get("n_nodes", 0) * d.get("batch", 1)
    E = d.get("n_edges", 0) * d.get("batch", 1)
    D, R = cfg.d_hidden, cfg.n_rbf
    per = 2 * E * (R * D + D * D + D) + 2 * N * (3 * D * D)
    return 3.0 * cfg.n_interactions * per


def bundle(smoke: bool = False) -> GNNBundle:
    return GNNBundle("schnet", schnet, _make_cfg, smoke=smoke,
                     flops_fn=_flops)
