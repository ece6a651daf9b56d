"""tortoise_tpu_torch — the PyTorch/CUDA port of tortoise_tpu for NVIDIA Hopper.

    from tortoise_tpu_torch.api import TextToSpeech      # quality path
    from tortoise_tpu_torch.utils.audio import load_voice, load_voices

Imports no jax, flax, HF tokenizers or anything of the JAX package
``tortoise_tpu``. The kernels are CUDA C++ in ``csrc/``, built with nvcc at
first use (``ops/_build.py``); the CLIs are in ``apps/``.
"""
