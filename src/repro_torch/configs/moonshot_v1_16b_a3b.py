"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048 16H
(GQA kv=16) d_ff=1408 per expert, vocab 163840, MoE 64 experts top-6."""
from repro_torch.configs.lm_common import LMBundle
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab_size=163840, moe=True, n_experts=64,
    top_k=6, rope_theta=50000.0)

SMOKE = TransformerConfig(
    name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=48, vocab_size=256, moe=True, n_experts=8, top_k=2,
    block_q=32, block_kv=32)


def bundle(smoke: bool = False) -> LMBundle:
    return LMBundle(SMOKE if smoke else CONFIG, smoke=smoke,
                    supports_long=False)
