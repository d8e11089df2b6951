"""The dataset preparation CLI, as the JAX package's ``cli/process_dataset.py``.

    python -m ssd_tensorflow_tpu_torch.cli.process_dataset --data-source pascal_voc --data-dir <dir>

Loads a dataset source (``data/sources.py``), optionally draws the ground
truth to ``<data-dir>/annotated/`` and writes what the train CLI reads:
``train-samples.pkl``, ``valid-samples.pkl`` (lists of the port's
``types.Sample``) and ``training-data.json``, byte for byte the JAX
CLI's. Host work only: no device is used.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

from ssd_tensorflow_tpu_torch.data import image_io
from ssd_tensorflow_tpu_torch.data.sources import load_data_source
from ssd_tensorflow_tpu_torch.presets import (
    SSD_PRESETS,
    get_preset_by_name,
    preset_to_dict,
)
from ssd_tensorflow_tpu_torch.types import str2bool


def annotate(data_dir, samples, colors, sample_name):
    """Render every sample's gt boxes to data_dir/annotated/<name>/."""
    try:
        from tqdm import tqdm
    except ImportError:
        def tqdm(x, **kw):
            return x

    result_dir = os.path.join(data_dir, "annotated", sample_name.strip())
    os.makedirs(result_dir, exist_ok=True)
    for sample in tqdm(samples, desc=sample_name, unit="samples"):
        img = image_io.imread(sample.filename)
        for box in sample.boxes:
            image_io.draw_box(img, box, colors[box.label])
        image_io.imwrite(os.path.join(result_dir, os.path.basename(sample.filename)), img)


def build_parser():
    parser = argparse.ArgumentParser(description="Process a dataset for SSD")
    parser.add_argument("--data-source", default="pascal_voc", help="data source")
    parser.add_argument("--data-dir", default="pascal-voc", help="data directory")
    parser.add_argument(
        "--validation-fraction",
        type=float,
        default=0.025,
        help="fraction of the data to be used for validation",
    )
    parser.add_argument(
        "--expand-probability",
        type=float,
        default=0.5,
        help="probability of running sample expander",
    )
    parser.add_argument(
        "--sampler-trials",
        type=int,
        default=50,
        help="number of times a sampler tries to find a sample",
    )
    parser.add_argument(
        "--annotate", type=str2bool, default="False", help="annotate the samples"
    )
    parser.add_argument(
        "--compute-td", type=str2bool, default="True", help="compute training data"
    )
    parser.add_argument(
        "--preset",
        default="vgg300",
        choices=sorted(SSD_PRESETS),
        help="the neural network preset",
    )
    parser.add_argument(
        "--process-test", type=str2bool, default="False", help="process the test set"
    )
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    print("[i] Data source:          ", args.data_source)
    print("[i] Data directory:       ", args.data_dir)
    print("[i] Validation fraction:  ", args.validation_fraction)
    print("[i] Expand probability:   ", args.expand_probability)
    print("[i] Sampler trials:       ", args.sampler_trials)
    print("[i] Annotate:             ", args.annotate)
    print("[i] Compute training data:", args.compute_td)
    print("[i] Preset:               ", args.preset)
    print("[i] Process test dataset: ", args.process_test)

    try:
        source = load_data_source(args.data_source)
        source.load_trainval_data(args.data_dir, args.validation_fraction)
        if args.process_test:
            source.load_test_data(args.data_dir)
        print("[i] # training samples:   ", source.num_train)
        print("[i] # validation samples: ", source.num_valid)
        print("[i] # testing samples:    ", source.num_test)
        print("[i] # classes:            ", source.num_classes)
    except (ImportError, AttributeError, RuntimeError) as e:
        print("[!] Unable to load data source:", str(e))
        return 1

    if args.annotate:
        print("[i] Annotating samples...")
        annotate(args.data_dir, source.train_samples, source.colors, "train")
        annotate(args.data_dir, source.valid_samples, source.colors, "valid")
        if args.process_test:
            annotate(args.data_dir, source.test_samples, source.colors, "test")

    if args.compute_td:
        preset = get_preset_by_name(args.preset)
        with open(os.path.join(args.data_dir, "train-samples.pkl"), "wb") as f:
            pickle.dump(source.train_samples, f)
        with open(os.path.join(args.data_dir, "valid-samples.pkl"), "wb") as f:
            pickle.dump(source.valid_samples, f)

        with open(os.path.join(args.data_dir, "training-data.json"), "w") as f:
            json.dump(
                {
                    "preset": preset_to_dict(preset),
                    "num-classes": source.num_classes,
                    "colors": {k: list(v) for k, v in source.colors.items()},
                    "lid2name": {str(k): v for k, v in source.lid2name.items()},
                    "lname2id": dict(source.lname2id),
                    "augmentation": {
                        "sampler_trials": args.sampler_trials,
                        "expand_probability": args.expand_probability,
                    },
                },
                f,
                indent=2,
            )
        print("[i] Artifacts written to", args.data_dir)
    return 0


def run():
    sys.exit(main())


if __name__ == "__main__":
    run()
