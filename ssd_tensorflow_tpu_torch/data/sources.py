"""Dataset source plugins, as the JAX package's ``data/sources.py``.

A source named ``foo`` is a module ``source_foo`` exposing ``get_source()``,
which returns a duck-typed object with:

* attributes ``num_classes, colors, lid2name, lname2id, num_train,
  num_valid, num_test, train_samples, valid_samples, test_samples``;
* methods ``load_trainval_data(data_dir, valid_fraction)`` and
  ``load_test_data(data_dir)``.

The port's own ``ssd_tensorflow_tpu_torch.data.source_<name>`` modules are
found first; a ``source_<name>.py`` module on ``sys.path`` still works, so
third-party plugins drop in unchanged.
"""

from __future__ import annotations

import importlib


def load_data_source(data_source: str):
    """Load a data source by name."""
    for modname in (f"ssd_tensorflow_tpu_torch.data.source_{data_source}",
                    f"source_{data_source}"):
        try:
            module = importlib.import_module(modname)
        except ImportError:
            continue
        return module.get_source()
    raise ImportError(f"no data source module found for '{data_source}'")
