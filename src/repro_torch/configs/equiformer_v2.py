"""equiformer-v2 [arXiv:2306.12059]: 12 layers, 128 channels, l_max=6,
m_max=2, 8 heads, SO(2)-eSCN convolutions.

The reference's ``REPRO_GNN_PERF`` environment switches (the chunked
paths, bf16) are perf knobs and are not read: the config is the
published one, on the default path.  A caller picks a chunked path
through the config's own field, e.g. ``dataclasses.replace(cfg,
node_chunks=16)`` over a batch binned by destination range.
"""
import dataclasses

from repro_torch.configs.gnn_common import GNNBundle
from repro_torch.models.gnn import equiformer_v2 as eq2


def _make_cfg(spec):
    d = spec.dims
    if spec.name == "molecule":
        return eq2.EquiformerV2Config(name="equiformer-v2", n_layers=12,
                                      d_hidden=128, l_max=6, m_max=2,
                                      n_heads=8, task="energy",
                                      n_graphs=d["batch"])
    return eq2.EquiformerV2Config(name="equiformer-v2", n_layers=12,
                                  d_hidden=128, l_max=6, m_max=2, n_heads=8,
                                  d_feat=d["d_feat"], task="node_class",
                                  n_classes=d["n_classes"])


def _flops(cfg, spec):
    d = spec.dims
    N = d.get("n_nodes", 0) * d.get("batch", 1)
    E = d.get("n_edges", 0) * d.get("batch", 1)
    C = cfg.d_hidden
    so2 = 0
    for m, (pos, neg) in enumerate(cfg.m_indices()):
        nl = len(pos)
        so2 += (1 if m == 0 else 4) * 2 * (nl * C) ** 2
    wig = 2 * sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1)) * C * 2
    per = E * (so2 + wig) + 4 * N * C * C * cfg.dim
    return 3.0 * cfg.n_layers * per


def _smoke_cfg(spec):
    """The model shrunk for CPU smoke runs (full l_max=6 is heavy)."""
    return dataclasses.replace(_make_cfg(spec), n_layers=2, d_hidden=16,
                               l_max=2, n_heads=4, n_rbf=16)


def bundle(smoke: bool = False) -> GNNBundle:
    return GNNBundle("equiformer-v2", eq2, _smoke_cfg if smoke else _make_cfg,
                     smoke=smoke, flops_fn=_flops)
