"""The LM transformer family's ArchBundle, the port of
``src/repro/configs/lm_common.py``.

The parameter leaves are named and shaped as the reference's tree
(``Transformer.reference_tree``: each layer leaf stacked ``[L, ...]``), the
checkpoint format too, so ``_param_pspec``'s rules, ZeRO-1 and
``train/elastic.py`` see the reference's leaves.  ``train_4k`` builds the
model with fp32 masters (``master=True``), as the reference's
``init_params`` does, so its argument leaves carry the reference's dtypes;
prefill and decode keep the serving model (a bf16 config's matmul weights
in bf16).  The reference's ``REPRO_LM_PERF`` knobs are not read
(``attn_p_bf16`` is refused by the model).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import (ArchBundle, P, ShapeSpec, dp_axes,
                                      mesh_axes, ns, params_spec_like,
                                      reference_specs, tree_map, zero1)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device
from repro_torch.train import optimizer as opt_mod

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode",
                           {"seq_len": 524288, "global_batch": 1}),
}


class LMBundle(ArchBundle):
    family = "lm"

    def __init__(self, cfg: tfm.TransformerConfig, smoke: bool = False,
                 supports_long: bool = False):
        self.cfg = cfg
        self.arch_id = cfg.name
        self.smoke = smoke
        self.shapes = dict(LM_SHAPES)
        if not supports_long:
            self.shapes["long_500k"] = dataclasses.replace(
                self.shapes["long_500k"],
                skip=("pure full-attention arch: 524k dense global KV "
                      "out of published scope (DESIGN.md §4)"))
        if smoke:
            self.shapes = {
                "train_4k": ShapeSpec("train_4k", "train",
                                      {"seq_len": 64, "global_batch": 2}),
                "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                         {"seq_len": 64, "global_batch": 2}),
                "decode_32k": ShapeSpec("decode_32k", "decode",
                                        {"seq_len": 64, "global_batch": 2}),
            }

    # ------------------------------------------------------------- abstract
    def init_params_abstract(self, master: bool = False) -> tfm.Transformer:
        """The model on meta: with ``master`` (a train step's) every leaf
        fp32, else the serving model's dtypes."""
        return tfm.Transformer(self.cfg, torch.device("meta"), master=master)

    def _params_sds(self):
        return reference_specs((self.init_params_abstract(),))[0]

    def adam_cfg(self):
        return opt_mod.AdamWConfig(total_steps=10000)

    # ----------------------------------------------------------------- step
    def make_step(self, shape: str):
        spec = self.shapes[shape]
        cfg, acfg = self.cfg, self.adam_cfg()
        if spec.kind == "train":
            return tfm.make_train_step(cfg, acfg)
        if spec.kind == "prefill":
            return functools.partial(_prefill_step, cfg=cfg)
        return functools.partial(_decode_step, cfg=cfg)

    def input_specs(self, shape: str):
        """The step's arguments on meta; a decode step's position is the
        host int ``seq_len - 1`` (the tick that reads the whole cache)."""
        spec = self.shapes[shape]
        B = spec.dims["global_batch"]
        S = spec.dims["seq_len"]
        meta = torch.device("meta")
        model = self.init_params_abstract(master=spec.kind == "train")
        if spec.kind == "train":
            tokens = torch.empty((B, S), dtype=torch.int32, device=meta)
            return (model, self.abstract_adam_state(model),
                    {"tokens": tokens})
        caches = tfm.init_kv_cache(self.cfg, B, S, device=meta)
        if spec.kind == "prefill":
            # a representative full-prompt call
            tokens = torch.empty((B, S), dtype=torch.int32, device=meta)
            return (model, tokens, caches)
        tokens = torch.empty((B, 1), dtype=torch.int32, device=meta)
        return (model, tokens, caches, S - 1)

    # ------------------------------------------------------------ shardings
    def _param_pspec(self, path, leaf):
        name = "/".join(path)
        nd = len(leaf.shape)
        if "embed" in name:
            return P("model", None)
        if "head" in name:
            return P(None, "model")
        if "router" in name:
            return P(None, None, None)
        if "mlp" in name and nd == 4:        # MoE experts [L, E, D, F]
            return P(None, "model", None, None)
        if any(k in name for k in ("wq", "wk", "wv", "w1", "w3")) and nd == 3:
            return P(None, None, "model")
        if any(k in name for k in ("wo", "w2")) and nd == 3:
            return P(None, "model", None)
        if any(k in name for k in ("bq", "bk", "bv")):
            return P(None, "model")
        return P(*([None] * nd))

    def param_shardings(self, mesh):
        return params_spec_like(
            self._params_sds(),
            lambda path, leaf: ns(mesh, *self._param_pspec(path, leaf)))

    def opt_shardings(self, mesh, ost_sds):
        dsize = mesh_axes(mesh)["data"]

        def spec_of(path, leaf):
            base = self._param_pspec(path, leaf)
            return ns(mesh, *zero1(base, leaf.shape, dsize, mesh))

        mu = params_spec_like(ost_sds.mu, spec_of)
        nu = params_spec_like(ost_sds.nu, spec_of)
        ef = tree_map(lambda _: ns(mesh), ost_sds.ef_error)
        return opt_mod.AdamState(step=ns(mesh), mu=mu, nu=nu, ef_error=ef)

    def _kv_divisible(self, mesh) -> bool:
        return self.cfg.n_kv_heads % mesh_axes(mesh)["model"] == 0

    def _cache_spec(self, mesh, B):
        dp = dp_axes(mesh)
        if self._kv_divisible(mesh):
            if B == 1:   # long-context: shard the sequence axis over data
                return ns(mesh, None, None, dp, "model", None)
            return ns(mesh, None, dp, None, "model", None)
        # kv heads don't divide the model axis: shard the sequence instead
        if B == 1:
            return ns(mesh, None, None, dp, None, None)
        return ns(mesh, None, dp, "model", None, None)

    def hints(self, mesh, kind: str = "train"):
        dp = dp_axes(mesh)
        h = {
            # Megatron sequence parallelism: the residual stream shards
            # over (dp, model)
            "act_resid": (ns(mesh, dp, "model", None) if kind != "decode"
                          else ns(mesh, dp, None, None)),
            "act_ff": ns(mesh, dp, None, "model"),
            "logits": ns(mesh, dp, None, "model"),
            "moe_buf": ns(mesh, "model", None, None),
            "moe_ff": ns(mesh, "model", None, None),
            "moe_rows": ns(mesh, dp, None),
            "moe_eout": ns(mesh, "model", None),
        }
        if self._kv_divisible(mesh):
            h["act_q"] = ns(mesh, dp, None, "model", None, None)
            h["act_kv"] = ns(mesh, dp, None, "model", None)
        return h

    def shardings(self, mesh, shape: str):
        spec = self.shapes[shape]
        dp = dp_axes(mesh)
        B = spec.dims["global_batch"]
        pshard = self.param_shardings(mesh)
        if spec.kind == "train":
            model = self.init_params_abstract(master=True)
            ost_sds = reference_specs(
                (model, self.abstract_adam_state(model)))[1]
            oshard = self.opt_shardings(mesh, ost_sds)
            batch_shard = {"tokens": ns(mesh, dp, None)}
            in_sh = (pshard, oshard, batch_shard)
            out_sh = (pshard, oshard, None)   # metrics: left open
            return in_sh, out_sh, self.hints(mesh, "train")
        cshard = {"k": self._cache_spec(mesh, B),
                  "v": self._cache_spec(mesh, B)}
        if spec.kind == "prefill":
            tok = ns(mesh, dp, None) if B > 1 else ns(mesh, None, dp)
            in_sh = (pshard, tok, cshard)
            out_sh = (ns(mesh, dp, "model") if B > 1
                      else ns(mesh, None, "model"), cshard)
            return in_sh, out_sh, self.hints(mesh, "prefill")
        tok = ns(mesh, dp, None) if B > 1 else ns(mesh, None, None)
        in_sh = (pshard, tok, cshard, ns(mesh))
        out_sh = (ns(mesh, dp, "model") if B > 1 else ns(mesh, None, "model"),
                  cshard)
        return in_sh, out_sh, self.hints(mesh, "decode")

    # ------------------------------------------------------------- concrete
    def make_concrete(self, shape: str, seed: int = 0, device=None):
        """Real small tensors on ``device`` (``None`` means cuda): weights
        from a ``torch.Generator`` seeded with ``seed`` (fp32 masters for
        ``train_4k``), the reference's tokens (the same draws) and zeroed
        caches."""
        assert self.smoke, "concrete inputs only for smoke bundles"
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        spec = self.shapes[shape]
        B, S = spec.dims["global_batch"], spec.dims["seq_len"]
        model = tfm.init_params(
            self.cfg, torch.Generator(device=dev).manual_seed(seed),
            device=dev, master=spec.kind == "train")

        def tokens(shape):
            return torch.as_tensor(rng.integers(0, self.cfg.vocab_size,
                                                shape).astype(np.int32),
                                   device=dev)

        if spec.kind == "train":
            ost = opt_mod.init(self.adam_cfg(), model.parameters())
            return (model, ost, {"tokens": tokens((B, S))})
        caches = tfm.init_kv_cache(self.cfg, B, S, device=dev)
        if spec.kind == "prefill":
            return (model, tokens((B, S)), caches)
        return (model, tokens((B, 1)), caches,
                torch.tensor(S // 2, dtype=torch.int32, device=dev))

    # ------------------------------------------------------------ analytics
    def model_flops(self, shape: str) -> float:
        spec = self.shapes[shape]
        B, S = spec.dims["global_batch"], spec.dims["seq_len"]
        if spec.kind == "train":
            return self.cfg.train_flops(B, S)
        if spec.kind == "prefill":
            return self.cfg.train_flops(B, S) / 3.0   # forward only
        return self.cfg.decode_flops(B, S)


def _prefill_step(params, tokens, caches, cfg):
    return tfm.prefill(params, tokens, cfg, caches)


def _decode_step(params, tokens, caches, t, cfg):
    return tfm.decode_step(params, tokens, cfg, caches, t)
