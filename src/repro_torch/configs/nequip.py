"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 Bessel RBF,
cutoff 5, E(3) tensor products."""
from repro_torch.configs.gnn_common import GNNBundle
from repro_torch.models.gnn import nequip


def _make_cfg(spec):
    d = spec.dims
    if spec.name == "molecule":
        return nequip.NequIPConfig(name="nequip", n_layers=5, d_hidden=32,
                                   l_max=2, n_rbf=8, cutoff=5.0,
                                   task="energy", n_graphs=d["batch"])
    return nequip.NequIPConfig(name="nequip", n_layers=5, d_hidden=32,
                               l_max=2, n_rbf=8, cutoff=5.0,
                               d_feat=d["d_feat"], task="node_class",
                               n_classes=d["n_classes"])


def _flops(cfg, spec):
    d = spec.dims
    N = d.get("n_nodes", 0) * d.get("batch", 1)
    E = d.get("n_edges", 0) * d.get("batch", 1)
    C = cfg.d_hidden
    cg = sum((2 * l3 + 1) * (2 * l1 + 1) * (2 * l2 + 1)
             for l1, l2, l3 in cfg.paths())
    per = 2 * E * C * cg + 4 * N * C * C * cfg.dim
    return 3.0 * cfg.n_layers * per


def bundle(smoke: bool = False) -> GNNBundle:
    return GNNBundle("nequip", nequip, _make_cfg, smoke=smoke,
                     flops_fn=_flops)
