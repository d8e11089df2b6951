"""The inference / evaluation CLI, as the JAX package's ``cli/infer.py``.

    python -m ssd_tensorflow_tpu_torch.cli.infer [files] [--bundle B | --name RUN] [flags]

Runs a training checkpoint's float model or an exported bundle (float or
int8) over explicit files and/or a dataset sample and, per flags, draws
the detections, dumps the raw ``(A, K+5)`` predictions as ``.npy``
(``InferenceModel.run``), computes VOC AP / mAP, and writes Pascal
eval-server and COCO results files. Batches are padded to
``--batch-size`` with the last file and trimmed, as the JAX CLI does. The
same flags as the JAX CLI, plus ``--device`` (``cuda`` unless asked for
``cpu``); ``--data-parallel N`` with N >= 1 exits 1 (ROADMAP.md queue 1
item 12). Images are decoded and drawn through ``data/image_io.py``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from ssd_tensorflow_tpu_torch.cli import DATA_PARALLEL_LEFT
from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.data.sources import load_data_source
from ssd_tensorflow_tpu_torch.eval.average_precision import APCalculator, APs2mAP
from ssd_tensorflow_tpu_torch.eval.coco_results import CocoResultsWriter
from ssd_tensorflow_tpu_torch.eval.pascal_summary import PascalSummary
from ssd_tensorflow_tpu_torch.inference import InferenceModel
from ssd_tensorflow_tpu_torch.ops.postprocess import DetectionConfig, detections_to_boxes
from ssd_tensorflow_tpu_torch.types import Size, str2bool
from ssd_tensorflow_tpu_torch.utils.checkpoint import find_checkpoint


def build_parser():
    parser = argparse.ArgumentParser(description="SSD inference")
    parser.add_argument("files", nargs="*", help="files to infer on")
    parser.add_argument("--name", default="test", help="project name")
    parser.add_argument(
        "--checkpoint", type=int, default=-1, help="checkpoint to restore; -1 is the most recent"
    )
    parser.add_argument(
        "--bundle", default=None,
        help="evaluate an exported inference bundle (float or int8, "
        "export_model.py output) instead of a training checkpoint — "
        "runs the exact deployed program through the same mAP/"
        "pascal-summary machinery",
    )
    parser.add_argument(
        "--training-data",
        default="pascal-voc/training-data.json",
        help="training data artifact (for label names and colors)",
    )
    parser.add_argument("--output-dir", default="test-output", help="output directory")
    parser.add_argument("--annotate", type=str2bool, default="False", help="annotate images")
    parser.add_argument(
        "--dump-predictions", type=str2bool, default="False",
        help="dump raw predictions as .npy",
    )
    parser.add_argument(
        "--compute-stats", type=str2bool, default="True",
        help="compute AP/mAP (requires --data-source)",
    )
    parser.add_argument("--data-source", default=None, help="dataset source")
    parser.add_argument("--data-dir", default="pascal-voc", help="dataset directory")
    parser.add_argument("--batch-size", type=int, default=32, help="batch size")
    parser.add_argument(
        "--sample", default="test", choices=["test", "trainval"], help="dataset sample"
    )
    parser.add_argument("--threshold", type=float, default=0.5, help="confidence threshold")
    parser.add_argument(
        "--padded-heads", action="store_true",
        help="lane-align the classifier head groups on TPU — same math, "
        "often faster (ModelConfig.padded_heads)",
    )
    parser.add_argument(
        "--data-parallel", type=int, default=0, metavar="N",
        help="shard each batch over N devices; only 0 (one device) is available in the "
        "port (ROADMAP.md queue 1 item 12)",
    )
    parser.add_argument(
        "--pascal-summary", type=str2bool, default="False",
        help="write Pascal eval-server submission files",
    )
    parser.add_argument(
        "--coco-results", type=str2bool, default="False",
        help="write detections as a COCO results JSON "
        "(<output-dir>/coco_results.json, COCOeval-consumable; image "
        "and category ids come from the --data-source coco maps)",
    )
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    for k, v in sorted(vars(args).items()):
        print(f"[i] {k.replace('_', ' ').capitalize():24s}: {v}")
    if args.data_parallel:
        print(DATA_PARALLEL_LEFT)
        return 1

    # checkpoint
    if args.bundle:
        ckpt_path = None
        print("[i] Bundle:", args.bundle)
    else:
        ckpt_path, epoch = find_checkpoint(args.name, args.checkpoint)
        if ckpt_path is None:
            print("[!] No checkpoints found in", args.name)
            return 1
        print("[i] Checkpoint:", ckpt_path)

    # label colors from the training-data artifact: the fallback when no
    # --data-source is given
    td_colors = {}
    if args.training_data and os.path.exists(args.training_data):
        try:
            with open(args.training_data) as f:
                td = json.load(f)
            td_colors = {k: tuple(v) for k, v in td.get("colors", {}).items()}
            print("[i] Label colors loaded from", args.training_data)
        except (OSError, ValueError) as e:
            print(f"[!] Could not read {args.training_data}: {e}")

    # dataset-provided files + ground truth
    source = None
    gt_by_file = {}
    files = list(args.files)
    if args.data_source:
        print("[i] Configuring the data source...")
        source = load_data_source(args.data_source)
        if args.sample == "test":
            source.load_test_data(args.data_dir)
            samples = source.test_samples
        else:
            source.load_trainval_data(args.data_dir, 0)
            samples = source.train_samples
        for s in samples:
            gt_by_file[s.filename] = s.boxes
        # skip sample files already passed explicitly — processing a
        # file twice would double-register its gt in APCalculator and
        # skew mAP
        explicit = set(files)
        files += [s.filename for s in samples if s.filename not in explicit]

    if not files:
        print("[!] No files to process")
        return 1

    detection = DetectionConfig(top_k=200, confidence_threshold=args.threshold)
    overrides = {"padded_heads": True} if args.padded_heads else {}
    if args.bundle:
        model = InferenceModel.from_bundle(
            args.bundle, detection=detection, overrides=overrides, device=args.device
        )
    else:
        model = InferenceModel.from_checkpoint(
            ckpt_path, detection=detection, overrides=overrides, device=args.device
        )

    os.makedirs(args.output_dir, exist_ok=True)

    ap_calc = APCalculator() if (args.compute_stats and gt_by_file) else None
    summary = PascalSummary() if args.pascal_summary else None
    coco_results = None
    if args.coco_results:
        coco_results = CocoResultsWriter(
            image_ids=getattr(source, "image_ids", None),
            cat_ids=getattr(source, "cat_ids", None),
        )

    try:
        from tqdm import tqdm
    except ImportError:
        def tqdm(x, **kw):
            return x

    n_batches = math.ceil(len(files) / args.batch_size)
    for off in tqdm(
        range(0, len(files), args.batch_size),
        total=n_batches,
        desc="[i] Processing",
        unit="batches",
    ):
        chunk = files[off : off + args.batch_size]
        # fixed-shape batches keep one compiled program: pad + trim
        padded = chunk + [chunk[-1]] * (args.batch_size - len(chunk))
        images, sizes = model.preprocess_files(padded)
        if args.dump_predictions:
            # raw (B, A, K+5) result tensor needed — the full-softmax path
            result, dets = model.run(images)
            result = result[: len(chunk)].cpu().numpy()
            boxes_list = detections_to_boxes(dets, model.lid2name)
        else:
            # throughput scores path (lazy softmax)
            boxes_list = model.detect_boxes(images)

        for i, fname in enumerate(chunk):
            boxes = boxes_list[i]
            base = os.path.basename(fname)
            if args.annotate:
                img = image_io.imread(fname)
                # colors from the source when available, else from the
                # training-data artifact
                colors = getattr(source, "colors", None) or td_colors
                for conf, box in boxes:
                    image_io.draw_box(img, box, colors.get(box.label, (0, 255, 0)))
                image_io.imwrite(os.path.join(args.output_dir, base), img)
            if args.dump_predictions:
                np.save(
                    os.path.join(args.output_dir, base + ".npy"),
                    result[i],
                )
            if ap_calc is not None and fname in gt_by_file:
                ap_calc.add_detections(gt_by_file[fname], boxes)
            if summary is not None:
                summary.add_detections(fname, boxes)
            if coco_results is not None:
                # the true size is known from preprocess: no second decode
                coco_results.add_detections(fname, boxes, Size(*sizes[i]))

    if ap_calc is not None:
        aps = ap_calc.compute_aps()
        for k in sorted(aps):
            print(f"[i] AP [{k}]: {aps[k]:.4f}")
        print(f"[i] mAP: {APs2mAP(aps):.4f}")

    if summary is not None:
        summary.write_summary(args.output_dir)
        print("[i] Pascal summary written to", args.output_dir)

    if coco_results is not None:
        results_path = os.path.join(args.output_dir, "coco_results.json")
        coco_results.write_results(results_path)
        print("[i] COCO results written to", results_path)

    print("[i] All done.")
    return 0


def run():
    sys.exit(main())


if __name__ == "__main__":
    run()
