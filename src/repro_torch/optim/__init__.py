"""The reference's optimizer: AdamW with global-norm clipping
(``adamw``) and its learning-rate schedules (``schedules``)."""
from .adamw import (AdamWConfig, adamw, adamw_init,  # noqa: F401
                    clip_by_global_norm)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
