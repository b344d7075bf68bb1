"""Bottleneck ResNet-50 trained from sharded binary records — the v6
notebook's Caltech-256 workflow (image directory tree -> TFRecords ->
ResNet-50 with antisymmetric 3x3 mid-convs; reference
`dataset_utils/tfrecord_generator.py` + `models/tfkeras_resnets.py:698-818`),
rebuilt on the DERT record format and the bottleneck models.

Port of the JAX package's ``examples/bottleneck_resnet_records.py``.  With no
image directory supplied, a tiny synthetic `<label>_<n>.png` tree is written
first so the example is self-contained; where Pillow is missing, the same
images are stored as raw arrays in the records instead.

    python -m differential_equations_resnet_tpu_torch.examples.bottleneck_resnet_records \
        [--images DIR] [--image-size 64]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.data import (
    ConvertLabelsToOneHot,
    DecodeImages,
    RecordDatasetCreator,
    RecordGenerator,
    Resize,
    UnpackImagesLabels,
    get_record_paths,
)
from differential_equations_resnet_tpu_torch.models import build_resnet, resnet_preset
from differential_equations_resnet_tpu_torch.train import Training


def synthetic_images(num_classes: int, per_class: int):
    """Class-colored noise images (48x48x3 uint8) and their labels."""
    rng = np.random.default_rng(0)
    images, labels = [], []
    for label in range(num_classes):
        for _ in range(per_class):
            arr = rng.integers(0, 80, (48, 48, 3), dtype=np.uint8)
            arr[..., label % 3] += np.uint8(120)
            images.append(arr)
            labels.append(label)
    return np.stack(images), np.asarray(labels, np.int64)


def write_synthetic_image_tree(root: str, num_classes: int, per_class: int) -> bool:
    """The synthetic images as PNGs named `<label>_<n>.png` (the reference's
    filename-derived-label convention, tfrecord_generator.py:211-217).
    Returns False, writing nothing, where Pillow is missing."""
    try:
        from PIL import Image
    except ImportError:
        return False
    os.makedirs(root, exist_ok=True)
    images, labels = synthetic_images(num_classes, per_class)
    for n, (arr, label) in enumerate(zip(images, labels)):
        Image.fromarray(arr).save(os.path.join(root, f"{label}_{n % per_class}.png"))
    return True


def write_synthetic_records(records: str, num_classes: int, per_class: int) -> None:
    """The synthetic images as raw-array records split 3:1 into train/ and
    val/ (the path without Pillow)."""
    images, labels = synthetic_images(num_classes, per_class)
    order = np.random.default_rng(1).permutation(len(images))
    n_val = int(round(len(images) * 0.25))
    for split, index in (("val", order[:n_val]), ("train", order[n_val:])):
        RecordGenerator().write_arrays(images[index], labels[index], os.path.join(records, split),
                                       prefix=f"caltech_like_{split}", num_files_per_record=32)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", default=None, help="image directory tree")
    parser.add_argument("--records", default=None, help="records output dir")
    parser.add_argument("--num-classes", type=int, default=4)
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--preset", default="resnet50",
                        choices=["resnet50", "resnet101", "resnet152"])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="dert_example_") as workdir:
        images = args.images or os.path.join(workdir, "images")
        records = args.records or os.path.join(workdir, "records")
        encoded = True
        if args.images is None:
            print(f"# writing synthetic image tree -> {images}")
            encoded = write_synthetic_image_tree(images, args.num_classes, per_class=24)
            if not encoded:
                print(f"# Pillow is missing: raw-array records -> {records}")
                write_synthetic_records(records, args.num_classes, per_class=24)

        if encoded:
            # 1. Directory tree -> sharded records with a train/val split
            #    (reference TFRecordGenerator.convert, tfrecord_generator.py:35-99).
            RecordGenerator().convert(
                input_directory=images,
                output_directory=records,
                prefix="caltech_like",
                num_files_per_record=32,
                train_val_split=0.25,
            )

        # 2. Records -> batched dataset with the preprocessor chain
        #    (reference TFRecordDatasetCreator, tfrecord_dataset_creator.py:24-122).
        size = (args.image_size, args.image_size)

        def creator(split, train):
            return RecordDatasetCreator(
                record_paths=get_record_paths(os.path.join(records, split)),
                batch_size=args.batch_size,
                preprocessors=[
                    UnpackImagesLabels(),
                    *([DecodeImages(channels=3)] if encoded else []),
                    Resize(target_size=size),
                    ConvertLabelsToOneHot(num_classes=args.num_classes),
                ],
                shuffle=train,
                repeat=True,
                shuffle_buffer_size=256,
            ).create_dataset()

        train_ds = creator("train", True)
        val_ds = creator("val", False)

        # 3. Bottleneck ResNet with antisymmetric 3x3 mid-convs
        #    (reference get_resnet_build_function presets, tfkeras_resnets.py:719-745).
        model = build_resnet(
            resnet_preset(
                args.preset,
                num_classes=args.num_classes,
                antisymmetric_mid=True,
                image_shape=(args.image_size, args.image_size, 3),
            ),
            generator=torch.Generator().manual_seed(0),
            device=args.device,
        )

        trainer = Training(
            model,
            train_dataset=train_ds,
            val_dataset=val_ds,
            batch_size=args.batch_size,
            record_summaries=False,
        )
        history = trainer.train(
            epochs=1,
            steps_per_epoch=args.steps,
            learning_rate_schedule=lambda step: 1e-3,
            eval_steps=2,
        )
        print("history:", history["train"][-1], history["eval"][-1])
        trainer.close()
    return history


if __name__ == "__main__":
    main()
