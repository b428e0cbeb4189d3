"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d=2048 16H (GQA kv=16) d_ff=1024
per expert, vocab 50304, MoE 64 experts top-8."""
from repro_torch.configs.lm_common import LMBundle
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, moe=True, n_experts=64, top_k=8,
    rope_theta=10000.0)

SMOKE = TransformerConfig(
    name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab_size=256, moe=True, n_experts=8, top_k=2,
    block_q=32, block_kv=32)


def bundle(smoke: bool = False) -> LMBundle:
    return LMBundle(SMOKE if smoke else CONFIG, smoke=smoke,
                    supports_long=False)
