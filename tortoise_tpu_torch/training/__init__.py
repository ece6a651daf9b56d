"""Training: the UnifiedVoice train step and its optimizer (port of
``tortoise_tpu/training``)."""
