"""Evaluation: Pascal VOC average precision (``average_precision``), the
VOC eval-server writer (``pascal_summary``) and the COCO results writer
(``coco_results``)."""

from ssd_tensorflow_tpu_torch import lazy_exports

#: the JAX package's public names, each imported from its module on first use
_EXPORTS = {
    "APCalculator": "average_precision",
    "APs2mAP": "average_precision",
    "PascalSummary": "pascal_summary",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
