"""The standalone detection CLI, as the JAX package's ``cli/detect.py``.

    python -m ssd_tensorflow_tpu_torch.cli.detect --model <bundle> files...

Runs an exported bundle (float or int8) over image files in batches of
``--batch-size`` (the last one padded with its last file), writing
annotated images and per-image ``.txt`` box dumps, one line ``label
labelid cx cy w h`` a detection. Needs only the bundle, which carries the
label map. The same flags as the JAX CLI, plus ``--device`` (``cuda``
unless asked for ``cpu``); ``--pallas-stem`` and ``--padded-heads`` pass
through as the façade's overrides, and ``--data-parallel N`` with N >= 1
exits 1 (ROADMAP.md queue 1 item 12). Images are decoded, drawn and
written through ``data/image_io.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ssd_tensorflow_tpu_torch.cli import DATA_PARALLEL_LEFT
from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.inference import InferenceModel
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig


def build_parser():
    parser = argparse.ArgumentParser(description="Detect objects in images")
    parser.add_argument("files", nargs="+", help="image files")
    parser.add_argument(
        "--model", default="model.ssdtpu.npz", help="exported model bundle"
    )
    parser.add_argument(
        "--training-data",
        default=None,
        help="optional training-data.json for label colors",
    )
    parser.add_argument("--output-dir", default="detect-output", help="output directory")
    parser.add_argument("--batch-size", type=int, default=32, help="batch size")
    parser.add_argument("--threshold", type=float, default=0.5, help="confidence threshold")
    parser.add_argument(
        "--padded-heads", action="store_true",
        help="accepted as the JAX CLI's flag: lane-aligned head groups are a TPU layout, "
        "the same math (a no-op here)",
    )
    parser.add_argument(
        "--pallas-stem", action="store_true",
        help="run conv1_2+pool1 as the split stem kernel (bf16 VGG float bundles, which "
        "always run a stem kernel in the port; ops/stem_cuda.py)",
    )
    parser.add_argument(
        "--data-parallel", type=int, default=0, metavar="N",
        help="shard each batch over N devices; only 0 (one device) is available in the "
        "port (ROADMAP.md queue 1 item 12)",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    print("[i] Model:      ", args.model)
    print("[i] Output dir: ", args.output_dir)
    print("[i] Batch size: ", args.batch_size)

    overrides = {}
    if args.padded_heads:
        overrides["padded_heads"] = True
    if args.pallas_stem:
        overrides["pallas_stem"] = True
    if args.data_parallel:
        print(DATA_PARALLEL_LEFT)
        return 1
    model = InferenceModel.from_bundle(
        args.model,
        detection=DetectionConfig(
            top_k=200, confidence_threshold=args.threshold
        ),
        overrides=overrides,
        device=args.device,
    )
    # (incompatible --pallas-stem combinations are reported and dropped
    # by InferenceModel itself)

    colors = {}
    if args.training_data:
        with open(args.training_data) as f:
            colors = {
                k: tuple(v) for k, v in json.load(f)["colors"].items()
            }

    os.makedirs(args.output_dir, exist_ok=True)

    files = args.files
    for off in range(0, len(files), args.batch_size):
        chunk = files[off : off + args.batch_size]
        padded = chunk + [chunk[-1]] * (args.batch_size - len(chunk))
        images, _ = model.preprocess_files(padded)
        boxes_list = model.detect_boxes(images)

        for i, fname in enumerate(chunk):
            boxes = boxes_list[i]
            base = os.path.basename(fname)
            img = image_io.imread(fname)
            lines = []
            for conf, box in boxes:
                image_io.draw_box(img, box, colors.get(box.label, (0, 255, 0)))
                lines.append(
                    f"{box.label} {box.labelid} {box.center.x} "
                    f"{box.center.y} {box.size.w} {box.size.h}\n"
                )
            image_io.imwrite(os.path.join(args.output_dir, base), img)
            with open(
                os.path.join(args.output_dir, base + ".txt"), "w"
            ) as f:
                f.writelines(lines)
            print(f"[i] {fname}: {len(boxes)} detections")

    print("[i] All done.")
    return 0


def run():
    sys.exit(main())


if __name__ == "__main__":
    run()
