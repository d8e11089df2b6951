"""Box math, decode, NMS and the CUDA kernels with their plain versions."""

from ssd_tensorflow_tpu_torch import lazy_exports

#: the JAX package's public names, each imported from its module on first use
_EXPORTS = {
    "anchors_for_preset": "anchors",
    "CANVAS_SIZE": "boxes",
    "box_canvas_corners": "boxes",
    "clamp_boxes": "boxes",
    "corners_to_cxcywh": "boxes",
    "cxcywh_to_corners": "boxes",
    "decode_locations": "codec",
    "encode_locations": "codec",
    "canvas_iou": "iou",
    "pairwise_canvas_iou": "iou",
    "pairwise_iou": "iou",
    "encode_targets": "matching",
    "match_anchors": "matching",
    "DetectionConfig": "postprocess",
    "decode_detections": "postprocess",
    "detect": "postprocess",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
