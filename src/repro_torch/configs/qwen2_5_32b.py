"""Qwen2.5-32B [hf:Qwen/Qwen2.5-32B]: 64L d=5120 40H (GQA kv=8) d_ff=27648
vocab 152064, QKV bias."""
from repro_torch.configs.lm_common import LMBundle
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0)

SMOKE = TransformerConfig(
    name="qwen-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256, qkv_bias=True, block_q=32, block_kv=32)


def bundle(smoke: bool = False) -> LMBundle:
    return LMBundle(SMOKE if smoke else CONFIG, smoke=smoke,
                    supports_long=False)
