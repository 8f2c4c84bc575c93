from .attention import (  # noqa: F401
    blockwise_attention, dense_attention, make_mask,
)
from .norms import layer_norm, rms_norm  # noqa: F401
from .pooling import pool_2d  # noqa: F401
from .quant import linear, quantize_linear  # noqa: F401
from .rope import apply_rope, rope_tables  # noqa: F401
from .sampling import denoise_commit, topk_transfer_mask  # noqa: F401
from .schedules import (  # noqa: F401
    num_transfer_tokens,
    num_transfer_tokens_scheduled,
    resolve_steps,
)
