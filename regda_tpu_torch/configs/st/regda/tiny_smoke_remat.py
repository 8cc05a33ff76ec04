"""tiny_smoke with per-block gradient checkpointing on (the reference's
with_cp, regda/resnet.py:140-168) — verify overlay."""
from regda_tpu_torch.configs.st.regda.tiny_smoke import *  # noqa: F401,F403

REMAT = True
