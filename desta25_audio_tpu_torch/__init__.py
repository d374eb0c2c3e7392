"""desta25_audio_tpu_torch: DeSTA2.5-Audio in PyTorch with hand-written
Hopper (sm_90a) CUDA kernels.

The port of the JAX/TPU package ``desta25_audio_tpu``, which stays the
reference.  This package imports torch and never jax.  Ported so far:
``DeSTA25AudioModel.generate()`` on the Q-Former and ORCA hybrid
configurations with transcriptions supplied, the Whisper encoder in bf16 or
int8 (W8A8), the LLM in bf16 or int8, the ORCA cross-attention stack float
or int8, plain or speculative decoding, on one GPU or tensor-parallel on a
device mesh (``parallel/``, K10); and training of the Q-Former and ORCA
configurations (``train/``, ``cli/train.py``) with the flash attention
kernel K11, on one GPU, on a device mesh (data parallel, the frozen LLM
cut tensor-parallel, the trainable state cut by fsdp) and across processes
(``parallel/distributed.py``); see ROADMAP.md for what follows.
"""

from .config import DeSTA25Config
from .models.desta import DeSTA25AudioModel, GenerationOutput

__all__ = ["DeSTA25AudioModel", "DeSTA25Config", "GenerationOutput"]
