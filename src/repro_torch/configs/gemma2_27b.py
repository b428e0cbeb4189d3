"""Gemma2-27B [arXiv:2408.00118]: 46L d=4608 32H (GQA kv=16) d_ff=36864
vocab 256000; local(4096)+global alternating, attn softcap 50, final softcap
30, pre+post zero-centered RMSNorm, head_dim 128.

Runs ``long_500k``: local layers bound attention to the 4096 window, global
layers attend over the full cache.
"""
from repro_torch.configs.lm_common import LMBundle
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    layer_pattern="local_global", window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    zero_centered_norm=True, rope_theta=10000.0)

SMOKE = TransformerConfig(
    name="gemma2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16, layer_pattern="local_global",
    window=16, attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    zero_centered_norm=True, block_q=32, block_kv=32)


def bundle(smoke: bool = False) -> LMBundle:
    return LMBundle(SMOKE if smoke else CONFIG, smoke=smoke,
                    supports_long=True)
