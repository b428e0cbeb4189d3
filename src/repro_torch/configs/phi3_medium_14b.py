"""Phi-3-medium-14B [arXiv:2404.14219]: 40L d=5120 40H (GQA kv=10)
d_ff=17920 vocab 100352, RoPE SwiGLU GQA."""
from repro_torch.configs.lm_common import LMBundle
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=10, d_ff=17920, vocab_size=100352, rope_theta=10000.0)

SMOKE = TransformerConfig(
    name="phi3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256, block_q=32, block_kv=32)


def bundle(smoke: bool = False) -> LMBundle:
    return LMBundle(SMOKE if smoke else CONFIG, smoke=smoke,
                    supports_long=False)
