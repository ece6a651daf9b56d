"""The plain references that judge a run (``check.py``): plain PyTorch in
float32, importing nothing of the program.

A configuration chooses the reference of its autoregressive (AR) prior
with the optional top-level key ``"reference": {"autoregressive":
"<module>"}``, a module of this package (``unified_voice``, GPT-2's
UnifiedVoice, where the key is absent). That module gives:

* ``NAME``: the class name of the program's model whose weights the
  benchmark makes (``weights.py``) and whose parameters the reference's
  must match;
* ``PROGRAM_CONFIG``: ``"<module>:<class>"``, a module of
  ``tortoise_tpu_torch``, the program's configuration class that
  ``system.Driver`` builds from the ``autoregressive`` group and hands the
  API as ``ar_config`` (a string: this package imports nothing of the
  program);
* ``SUPPRESSED``: ``(parameter, indices, value)``, the logit bias the
  benchmark's weights set on both sides so that the random prior never
  emits the calm, start or stop codes (``weights.make``, which raises
  where the model has no such parameter);
* ``build(ar) -> nn.Module``: the reference model of the configuration's
  ``autoregressive`` group, raising ``ValueError`` that names any key of
  ``ar`` the module does not know (a key that only the program reads is
  named in the module as ignored on purpose). The model has ``config``
  with ``max_text_tokens`` and ``stop_mel_token``, ``conditioning(mels)``
  (``(1, clips, T, 80)`` -> ``(1, D)``) and ``teacher_forced(cond, text,
  codes, served_positions) -> (logits, latents)``, as
  ``unified_voice.UnifiedVoice`` documents them;
* ``trunk_ops(ar, batch, new, context)``: the model operations of the
  layer stack over ``new`` tokens a row after ``context`` earlier ones
  (``counts.request_ops`` counts the prompt, each decode step and the
  latent re-extraction with it);
* ``conditioning_ops(ar, frames, clips)``: the conditioning encoder's
  operations over ``clips`` clips of ``frames`` mel frames.

So a new AR architecture enters as new files: its reference module here,
its configuration naming it, and its cells' limits, metrics and kernel
bounds.
"""
from __future__ import annotations

import importlib
import re

DEFAULT_AR = "unified_voice"
INTERFACE = ("NAME", "PROGRAM_CONFIG", "SUPPRESSED", "build", "trunk_ops", "conditioning_ops")
_MODULE_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def autoregressive(config: dict):
    """The reference module that a configuration names for its AR prior."""
    name = config.get("reference", {}).get("autoregressive", DEFAULT_AR)
    if not isinstance(name, str) or not _MODULE_NAME.match(name):
        raise ValueError(f"reference.autoregressive {name!r} is no module name")
    full = f"{__name__}.{name}"
    try:
        module = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"reference.autoregressive names {name!r}: no module {full}") from e
    missing = [n for n in INTERFACE if not hasattr(module, n)]
    if missing:
        raise ValueError(f"AR reference {full} lacks {', '.join(missing)}")
    return module
