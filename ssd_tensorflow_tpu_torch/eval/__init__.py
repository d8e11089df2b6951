"""Evaluation: Pascal VOC average precision (``average_precision``)."""
