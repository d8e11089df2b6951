"""A configuration's model family: the module ``reference/<family>.py``
that the configuration's ``"family"`` key names, or ``reference/ssd_ref.py``
(SSD with a VGG-16 trunk) where it has none. What the benchmark knows of
one architecture lives in its family module, and the harness reaches it
only through :func:`of`; a new family is a new module and a configuration
that names it.

A family module is plain float32 PyTorch (TF32 off), imports nothing of
the program and nothing of JAX, and provides:

* ``conv_records(cfg, batch)``: every convolution of the forward at
  ``batch`` in forward order, heads last, as dicts of ``name, b, hin,
  win, cin, ho, wo, cout, k, groups, reads_image`` (``benchlib/counts.py``
  counts operations and bytes from them);
* ``seeded_params(cfg, seed, device)``: the float32 parameters drawn on
  ``device`` from the seed, in the program's layout (configurations whose
  ``weights`` are ``seed``);
* ``read_int8_bundle(path, cfg)``: the arrays of the int8 bundle at
  ``path`` (configurations whose ``weights`` are ``bundle``);
* ``serving_forward(cfg, given, control=False)``: a function of ``(B, H,
  W, 3)`` uint8 BGR images to float32 ``(logits (B, A, K+1), locs (B, A,
  4))``, from ``given`` (the bundle's path or the seeded parameters), with
  TF32 off; ``control`` computes it a precision below the
  configuration's (int8 -> int4, bf16 -> fp8);
* ``anchors(preset)`` and ``detect(logits, locs, anchors, detection)``:
  the anchors and the detection step, as dicts that
  ``benchlib/check.serving_numbers`` takes (SSD families take
  ``ssd_ref``'s);
* ``sgd_step(params, trace, batch, anchors, cfg, quant=None)`` and
  ``train_control`` (the ``quant`` of the training control), only where
  the family has a train cell.
"""

from __future__ import annotations

import importlib

from benchlib.registry import BENCH_DIR

#: the family of a configuration without a ``"family"`` key
DEFAULT = "ssd_ref"


def name(cfg: dict) -> str:
    return cfg.get("family", DEFAULT)


def of(cfg: dict):
    """The family module of ``cfg``; raises with the path it looked for
    where there is none."""
    fam = name(cfg)
    path = BENCH_DIR / "reference" / f"{fam}.py"
    if not fam.isidentifier() or not path.is_file():
        raise ValueError(f"{cfg.get('name', 'a configuration')} names the family {fam!r}, "
                         f"but there is no {path}")
    return importlib.import_module(f"reference.{fam}")


def train_reference(cfg: dict):
    """The family module of ``cfg``, where it has a train step's reference;
    raises otherwise (never another family's)."""
    fam = of(cfg)
    if not hasattr(fam, "sgd_step"):
        raise ValueError(f"{cfg.get('name', 'a configuration')}: the family {name(cfg)!r} "
                         f"has no train reference (sgd_step in {fam.__file__})")
    return fam
