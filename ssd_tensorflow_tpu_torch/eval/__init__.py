"""Evaluation: Pascal VOC average precision (``average_precision``), the
VOC eval-server writer (``pascal_summary``) and the COCO results writer
(``coco_results``)."""
