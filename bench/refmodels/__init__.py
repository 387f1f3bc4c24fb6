"""The plain reference models, one module a kind of model, found by name.

A configuration file names its module with the key ``"reference"``
(``bench/refmodels/<name>.py``); without the key it is
:data:`DEFAULT`. Everything the benchmark knows of a model's shapes and
mathematics goes through that module: the seeded parameters
(``reference.make_params``), the checked steps (``reference.train_readings``),
the model FLOPs behind ``mfu`` and the gradient stream's size behind the
codec's rooflines (``yardstick``). A new architecture therefore comes as a
new module here and a configuration file that names it; no file of the
benchmark changes.

A module fills in, for a configuration ``cfg`` (the file's dict):

- ``layout(cfg) -> modelparts.Layout``: ``(path, shape, dtype, fan_in)``
  of every trained leaf, sorted by the path's ``/``-separated parts, in
  the order and under the names of the program's parameter tree
  (``repro_torch.models.params.ParamTree``); ``fan_in`` 0 marks a
  leaf made as ones (a norm's scale). ``reference.make_params`` draws
  the values; the sum of the shapes is the stream the codec sends.
- ``loss_fn(P, cfg, tokens, labels, prec="f32")``: the scalar training
  loss of ids ``tokens`` (B, S) against ``labels`` (B, S), from the float32
  leaves ``P`` (path -> tensor); every product through ``modelparts.mm``
  (``prec="fp8"`` is the control) and the shared pieces of ``modelparts``
  (``rmsnorm``, ``rope``, ``fake_quant``) where they fit. A module
  imports ``modelparts``, never ``reference``, which imports it.
- ``matmul_params_per_token(cfg) -> int``: the weights one token meets in
  a product, forward (a lookup counts nothing; routed experts count the
  ones a token is sent to).
- ``attention_flops_per_token(cfg, seq_len) -> int``: the FLOPs a trained
  token spends in products between activations at ``seq_len`` (for
  attention, the scores and the values), forward and backward.

A trained token's model FLOPs are ``6 * matmul_params_per_token +
attention_flops_per_token``.
"""

from __future__ import annotations

import importlib
from typing import Dict

DEFAULT = "decoder"


def for_config(cfg: Dict):
    """The reference module that ``cfg`` names."""
    return importlib.import_module(f"{__name__}.{cfg.get('reference', DEFAULT)}")
