"""tortoise_tpu_torch — the PyTorch/CUDA port of tortoise_tpu for NVIDIA Hopper.

    from tortoise_tpu_torch.api import TextToSpeech      # quality path
    from tortoise_tpu_torch.utils.audio import load_voice, load_voices

Imports no jax, flax or HF tokenizers. The kernels of the quality path are
CUDA C++ in ``csrc/``, built with nvcc at first use (``ops/_build.py``).
"""
