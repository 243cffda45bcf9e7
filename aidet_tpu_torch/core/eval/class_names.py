"""Dataset class-name registry (parity: mmdet/core/evaluation/class_names.py).

A copy of `aidet_tpu/core/eval/class_names.py`."""

from __future__ import annotations

DOTA_CLASSES = (
    "harbor", "ship", "small-vehicle", "large-vehicle", "storage-tank",
    "plane", "soccer-ball-field", "bridge", "baseball-diamond",
    "tennis-court", "helicopter", "roundabout", "swimming-pool",
    "ground-track-field", "basketball-court")

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic_light", "fire_hydrant", "stop_sign",
    "parking_meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports_ball", "kite", "baseball_bat", "baseball_glove", "skateboard",
    "surfboard", "tennis_racket", "bottle", "wine_glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot_dog", "pizza", "donut", "cake", "chair",
    "couch", "potted_plant", "bed", "dining_table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell_phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy_bear", "hair_drier", "toothbrush")

BUILDCHANGE_CLASSES = ("building",)

dataset_aliases = {
    "dota": DOTA_CLASSES,
    "voc": VOC_CLASSES,
    "coco": COCO_CLASSES,
    "buildchange": BUILDCHANGE_CLASSES,
}


def get_classes(dataset: str):
    if dataset in dataset_aliases:
        return dataset_aliases[dataset]
    raise ValueError(f"unknown dataset: {dataset}")
