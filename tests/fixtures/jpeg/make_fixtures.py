"""Write the JPEG fixtures of the port's tests and of chip_smoke.py.

    python tests/fixtures/jpeg/make_fixtures.py

needs OpenCV (the card's machine has none: it reads what this wrote):

- ``dota/``: six train patches of ``data/dota_e2e_xl`` (512^2 baseline
  4:2:0 JPEG, none with an ignored object), copied, and ``dota.json``,
  their entries of ``train_patches.json`` (images, annotations,
  categories);
- ``small/``: seeded images written by ``cv2.imwrite`` across sampling
  (4:4:4, 4:2:2, 4:2:0, grey), quality, odd sizes, a restart interval,
  optimised Huffman tables, and a progressive file that must be
  refused;
- ``decodes.json``: for each file, the shape and the sha256 of
  ``cv2.imread(path)``'s array (C order), or the word the port's
  refusal must contain.
"""

import hashlib
import json
import os
import shutil

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
DOTA = os.path.join(REPO, "data", "dota_e2e_xl")
PATCHES = ("P0212__1.0__384___384.jpg", "P0101__1.0__0___388.jpg",
           "P0235__1.0__388___384.jpg", "P0057__1.0__384___0.jpg",
           "P0101__1.0__0___0.jpg", "P0017__1.0__388___384.jpg")
S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# name: (height, width, quality, sampling or "grey", extra imwrite params)
SMALL = {
    "q50_444_17x33.jpg": (17, 33, 50, "444", []),
    "q95_422_333x517.jpg": (333, 517, 95, "422", []),
    "q5_420_517x333.jpg": (517, 333, 5, "420", []),
    "grey_q75_33x17.jpg": (33, 17, 75, "grey", []),
    "q75_420_1x1.jpg": (1, 1, 75, "420", []),
    "rst2_q75_420_61x93.jpg": (61, 93, 75, "420",
                               [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "optimized_q90_420_120x90.jpg": (120, 90, 90, "420",
                                     [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
    "progressive_q75_64x64.jpg": (64, 64, 75, "420",
                                  [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
}


def scene(h, w, seed):
    """A smooth seeded colour field with edges and noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / (3 + c) + y / (5 + 2 * c) + c)
                    for c in range(3)], -1)
    img[(x // 7 + y // 5) % 3 == 0] *= 0.6
    img += rs.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    os.makedirs(os.path.join(HERE, "dota"), exist_ok=True)
    os.makedirs(os.path.join(HERE, "small"), exist_ok=True)
    with open(os.path.join(DOTA, "train_patches.json")) as f:
        coco = json.load(f)
    images = [i for i in coco["images"] if i["file_name"] in PATCHES]
    ids = {i["id"] for i in images}
    with open(os.path.join(HERE, "dota.json"), "w") as f:
        json.dump(dict(images=images, categories=coco["categories"],
                       annotations=[a for a in coco["annotations"]
                                    if a["image_id"] in ids]), f)
    for name in PATCHES:
        shutil.copy(os.path.join(DOTA, "train_patches", name),
                    os.path.join(HERE, "dota", name))
    for k, (name, (h, w, q, samp, extra)) in enumerate(SMALL.items()):
        img = scene(h, w, k)
        params = [cv2.IMWRITE_JPEG_QUALITY, q] + extra
        if samp == "grey":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        else:
            params += [S, SAMPLING[samp]]
        assert cv2.imwrite(os.path.join(HERE, "small", name), img, params)
    decodes = {}
    for sub in ("dota", "small"):
        for name in sorted(os.listdir(os.path.join(HERE, sub))):
            rel = f"{sub}/{name}"
            if name.startswith("progressive"):
                decodes[rel] = dict(refused="progressive")
                continue
            img = cv2.imread(os.path.join(HERE, sub, name))
            decodes[rel] = dict(shape=list(img.shape), sha256=hashlib.sha256(
                np.ascontiguousarray(img).tobytes()).hexdigest())
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(decodes, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
