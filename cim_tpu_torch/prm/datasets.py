"""Multi-label classification datasets, transforms and finetune() groups
for PRM training (port of cim_tpu/prm/datasets.py; reference lib/prm).

- prm_configs.py:13-30 train/open transforms: Resize([448,448]) bilinear,
  (train only) random hflip p=0.5, scale to [0,1], ImageNet
  mean/std normalize; categories_dict (20 VOC classes, alphabetic).
- prm_configs.py:65-101 VOC_Classification: integer image-name list from
  ImageSets/Main/<split>.txt, per-image 20-dim multi-hot labels from the
  cls_labels.npy dict, filenames decoded as YYYY_NNNNNN.
- coco_dataset.py:68-103 COCO_Classification: 80-dim multi-hot target
  over contiguous category indices (coco_id_num_map).
- voc_dataset.py:183-210 VOCWeak: XML annotations -> (448-normalized
  image, 21-dim multi-hot with background slot, boxes, class indices
  with background=0 offset, stem filename).
- prm_configs.py:47-62 finetune(): fnmatch '*query*' parameter groups
  with per-group learning-rate multipliers (rest at base_lr), here torch
  SGD parameter groups over the model's parameter names (the reference's:
  the recipe's {'feature': 0.01} slows the backbone, features.*).

The host pipeline is cim_tpu's numpy code: images come out (448, 448, 3)
float32, HWC; the trainer moves them to the card as NCHW.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from fnmatch import fnmatch

import numpy as np

from cim_tpu_torch.data.voc_meta import VOC_CLASSES, coco_id_num_map

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# reference prm_configs.py:26-30 (identical to alphabetic VOC_CLASSES order)
CATEGORIES_DICT = {name: i for i, name in enumerate(VOC_CLASSES)}


def prm_transform(img_uint8, hflip: bool = False, size: int = 448):
    """The reference train/open transform (prm_configs.py:13-24): resize to
    (size, size) bilinear, optional hflip, [0,1] scale, ImageNet normalize.
    Input HWC uint8 (RGB), output (size, size, 3) float32."""
    from PIL import Image

    im = Image.fromarray(img_uint8).resize((size, size), Image.BILINEAR)
    x = np.asarray(im, np.float32) / 255.0
    if hflip:
        x = x[:, ::-1]
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def decode_int_filename(int_filename) -> str:
    """2007000032 -> '2007_000032' (prm_configs.py:71-73)."""
    s = str(int(int_filename))
    return s[:4] + "_" + s[4:]


def load_img_name_list(path):
    """Integer image ids from an ImageSets txt (prm_configs.py:66-68)."""
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def load_cls_labels(path) -> dict:
    """The cls_labels.npy dict: int image id -> (20,) float32 multi-hot."""
    return np.load(path, allow_pickle=True).item()


class VOCClassification:
    """VOC multi-label classification dataset (prm_configs.py:75-101).

    Yields (image (448,448,3) f32, target (20,) f32). Training
    augmentation (hflip) is driven by the rng argument of __getitem__
    so the pipeline stays functionally seedable.
    """

    def __init__(self, data_dir, split="trainaug", cls_labels_path=None,
                 train: bool = True, size: int = 448):
        self.data_dir = data_dir
        self.image_dir = os.path.join(data_dir, "JPEGImages")
        self.img_name_list = load_img_name_list(
            os.path.join(data_dir, "ImageSets", "Main", split + ".txt")
        )
        labels = load_cls_labels(
            cls_labels_path or os.path.join(data_dir, "cls_labels.npy")
        )
        self.label_list = np.array(
            [labels[int(n)] for n in self.img_name_list], np.float32
        )
        self.train = train
        self.size = size

    def __len__(self):
        return len(self.img_name_list)

    def __getitem__(self, index, rng: np.random.RandomState | None = None):
        from PIL import Image

        name = decode_int_filename(self.img_name_list[index])
        img = np.asarray(
            Image.open(os.path.join(self.image_dir, name + ".jpg")).convert("RGB")
        )
        hflip = bool(self.train and rng is not None and rng.rand() < 0.5)
        return (
            prm_transform(img, hflip=hflip, size=self.size),
            self.label_list[index].copy(),
        )


class COCOClassification:
    """COCO multi-label classification dataset (coco_dataset.py:68-103):
    target is an 80-dim multi-hot over contiguous category indices."""

    def __init__(self, data_dir, ann_file, train: bool = True,
                 size: int = 448):
        from cim_tpu_torch.evaluation.coco import COCO

        self.data_dir = data_dir
        self.coco = COCO(ann_file)
        self.ids = list(self.coco.imgs.keys())
        self.train = train
        self.size = size

    def __len__(self):
        return len(self.ids)

    def target(self, index):
        img_id = self.ids[index]
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
        t = np.zeros(80, np.float32)
        for obj in anns:
            t[coco_id_num_map[obj["category_id"]]] = 1.0
        return t

    def __getitem__(self, index, rng: np.random.RandomState | None = None):
        from PIL import Image

        img_id = self.ids[index]
        path = self.coco.loadImgs([img_id])[0]["file_name"]
        img = np.asarray(
            Image.open(os.path.join(self.data_dir, path)).convert("RGB")
        )
        hflip = bool(self.train and rng is not None and rng.rand() < 0.5)
        return prm_transform(img, hflip=hflip, size=self.size), self.target(index)


def parse_voc_objects(xml_path):
    """(boxes (N,4) f32 xyxy, class indices (N,) with background=0 offset,
    stem filename) from a VOC XML (voc_dataset.py:192-210)."""
    tree = ET.parse(xml_path)
    objects = tree.findall("object")
    boxes = np.zeros((len(objects), 4), np.float32)
    cls = np.zeros(len(objects), np.int64)
    for i, ob in enumerate(objects):
        bb = ob.find("bndbox")
        boxes[i] = [float(bb.find(k).text)
                    for k in ("xmin", "ymin", "xmax", "ymax")]
        # VOCWeak's CLS_TO_IND includes __background__ at 0 -> +1 offset
        cls[i] = CATEGORIES_DICT[ob.find("name").text.lower().strip()] + 1
    fname = tree.find("filename").text
    return boxes, cls, os.path.splitext(fname)[0]


class VOCWeak:
    """Weak-supervision VOC view (voc_dataset.py:183-210): per image the
    open-transformed 448x448 tensor, a 21-dim multi-hot (background slot
    0 stays 0 unless annotated), boxes, class indices, and the stem."""

    def __init__(self, root, image_set="sbdval", size: int = 448):
        voc_root = os.path.join(root, "VOCdevkit", "VOC2012")
        if not os.path.isdir(voc_root):
            # also accept a flat VOC2012-style root (tests / local layouts)
            voc_root = root
        self.image_dir = os.path.join(voc_root, "JPEGImages")
        ann_dir = os.path.join(voc_root, "Annotations")
        split_f = os.path.join(voc_root, "ImageSets", "Main",
                               image_set.rstrip("\n") + ".txt")
        with open(split_f) as f:
            names = [x.strip() for x in f.readlines()]
        self.images = [os.path.join(self.image_dir, x + ".jpg") for x in names]
        self.annotations = [os.path.join(ann_dir, x + ".xml") for x in names]
        self.size = size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        from PIL import Image

        img = np.asarray(Image.open(self.images[index]).convert("RGB"))
        boxes, cls, stem = parse_voc_objects(self.annotations[index])
        img_labels = np.zeros(21, np.float32)
        img_labels[cls] = 1.0
        return (prm_transform(img, size=self.size), img_labels, boxes, cls,
                stem)


def iterate_batches(dataset, batch_size: int, rng: np.random.RandomState,
                    shuffle: bool = True):
    """Fixed-shape host batching: drops the ragged tail; yields (images
    (B, 448, 448, 3) NHWC, targets (B, C)) float32."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    n_full = len(order) // batch_size
    for b in range(n_full):
        idx = order[b * batch_size:(b + 1) * batch_size]
        pairs = [dataset.__getitem__(int(i), rng=rng) for i in idx]
        yield (np.stack([p[0] for p in pairs]),
               np.stack([p[1] for p in pairs]))


# ----------------------- finetune() param groups ------------------------ #

def finetune_group_of(name: str, groups) -> str:
    """The finetune() group of a parameter name (prm_configs.py:47-62): the
    first group whose '*query*' fnmatch hits it, else 'rest'."""
    for q in groups:
        if fnmatch(name, f"*{q}*"):
            return q
    return "rest"


def finetune_param_groups(model, base_lr: float, groups: dict):
    """torch optimizer parameter groups of finetune(): each group's
    parameters at lr * base_lr, the rest at base_lr (groups with no
    parameter are left out)."""
    members = {q: [] for q in list(groups) + ["rest"]}
    for name, p in model.named_parameters():
        if p.requires_grad:
            members[finetune_group_of(name, groups)].append(p)
    lrs = {**{q: lr * base_lr for q, lr in groups.items()}, "rest": base_lr}
    return [{"params": ps, "lr": lrs[q], "name": q} for q, ps in members.items() if ps]
