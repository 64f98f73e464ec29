"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]."""
from .base import LMConfig, MoEConfig, MLAConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128, n_kv=128,
    d_ff=18432,  # dense prefix layers' FFN width
    vocab=129280,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1,
                  first_k_dense=3),
    mla=MLAConfig(q_lora=1536, kv_lora=512, dh_nope=128, dh_rope=64, dh_v=128),
    mtp_depth=1,
)
