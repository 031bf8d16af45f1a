"""Host-side record transforms of the flagship's chain: a copy of the classes
of `simpledet_tpu/data/transforms.py` that `standard_transforms`,
`multiscale_transforms` and the flagship configs name, kept in the port so
that it imports nothing of the JAX package.

Each transform mutates a record dict of numpy arrays. Images stay HWC uint8
through the chain: Norm2DImage is deferred to the device
(`ops/image.py::device_normalize`), and every transform here keeps the dtype.
Record keys: image [H, W, 3] RGB, gt_bbox [G, 5] (xyxy + class, -1 padded),
im_info [h', w', scale], h, w, im_id, rec_id, flipped.

`from_config` turns the transforms a config recorded (`core/config.py`'s
stand-ins: a class name and its arguments) into these, or into the polygon
transforms of `data/mask_transforms.py`; a transform that a config built
from this module itself (the mask configs import it as the JAX package's
`simpledet_tpu.data.transforms`) is taken as it is.
"""
import numpy as np


class DetectionAugmentation:
    """Base class of the record transforms."""

    def apply(self, record):
        raise NotImplementedError


class ReadRoiRecord(DetectionAugmentation):
    """cv2.imread BGR -> RGB uint8; also makes the gt arrays from the roidb
    lists."""

    def __init__(self, gt_select=None):
        self.gt_select = gt_select

    def apply(self, r):
        import cv2

        img = cv2.imread(r["image_url"], cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot read {r['image_url']}")
        r["image"] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        r["gt_bbox"] = np.asarray(r.get("gt_bbox", []),
                                  np.float32).reshape(-1, 4)
        r["gt_class"] = np.asarray(r.get("gt_class", []),
                                   np.float32).reshape(-1)
        return r


class Norm2DImage(DetectionAugmentation):
    """Pixel normalisation, deferred: a uint8 image passes unchanged and the
    device normalises it (`device_normalize`, which the trainer and the CLIs
    call with this transform's mean and std). A float image is normalised
    here, as the reference does."""

    def __init__(self, pNorm):
        self.mean = np.asarray(pNorm.mean, np.float32)
        self.std = np.asarray(pNorm.std, np.float32)

    def apply(self, r):
        img = r["image"]
        if img.dtype == np.uint8:
            return r
        img = np.asarray(img, np.float32)
        np.subtract(img, self.mean, out=img)
        if not np.all(self.std == 1.0):
            np.divide(img, self.std, out=img)
        r["image"] = img
        return r


def _scale_clip_gt(gt_bbox, scale, nh, nw):
    """Scale gt coordinates and clip them to the resized image."""
    gt = gt_bbox.astype(np.float32, copy=True)
    gt[:, :4] *= scale
    gt[:, [0, 2]] = np.clip(gt[:, [0, 2]], 0, nw - 1)
    gt[:, [1, 3]] = np.clip(gt[:, [1, 3]], 0, nh - 1)
    return gt


def _resize(r, short, long_):
    """Aspect-preserving resize of r's image to fit short x long; writes
    im_info = [h', w', scale] and scales and clips the gt boxes."""
    import cv2

    img = r["image"]
    h, w = img.shape[:2]
    scale = min(short / min(h, w), long_ / max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    r["image"] = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    if len(r["gt_bbox"]):
        r["gt_bbox"] = _scale_clip_gt(r["gt_bbox"], scale, nh, nw)
    r["im_info"] = np.array([nh, nw, scale], np.float32)
    return r


class Resize2DImageBbox(DetectionAugmentation):
    """Aspect-preserving short/long-side resize (`_resize`)."""

    def __init__(self, pResize):
        self.short = pResize.short
        self.long = pResize.long

    def apply(self, r):
        return _resize(r, self.short, self.long)


class RandResize2DImageBbox(DetectionAugmentation):
    """Multi-scale train resize: each record takes one of the (short, long)
    pairs, drawn by numpy's global generator (`np.random.randint`, as the
    JAX package draws it), then `_resize`."""

    def __init__(self, pResize):
        self.scales = list(zip(pResize.short, pResize.long))

    def apply(self, r):
        short, long_ = self.scales[np.random.randint(len(self.scales))]
        return _resize(r, short, long_)


class Flip2DImageBbox(DetectionAugmentation):
    """Horizontal flip when record['flipped']."""

    def apply(self, r):
        if r.get("flipped"):
            img = r["image"]
            w = img.shape[1]
            r["image"] = img[:, ::-1]
            if len(r["gt_bbox"]):
                bb = r["gt_bbox"].copy()
                x1 = bb[:, 0].copy()
                bb[:, 0] = w - 1 - bb[:, 2]
                bb[:, 2] = w - 1 - x1
                r["gt_bbox"] = bb
        return r


class Pad2DImageBbox(DetectionAugmentation):
    """Pad the image to the batch's fixed shape, (long, short) or (short,
    long) by orientation, and the gt to max_num_gt rows of -1; the class goes
    to gt_bbox's column 4."""

    def __init__(self, pPad):
        self.short = pPad.short
        self.long = pPad.long
        self.max_num_gt = pPad.max_num_gt

    def apply(self, r):
        img = r["image"]
        h, w = img.shape[:2]
        if h >= w:
            ph, pw = self.long, self.short
        else:
            ph, pw = self.short, self.long
        out = np.zeros((ph, pw, 3), img.dtype)
        out[:h, :w] = img
        r["image"] = out

        gt = np.full((self.max_num_gt, 5), -1, np.float32)
        n = min(len(r["gt_bbox"]), self.max_num_gt)
        if n:
            gt[:n, :4] = r["gt_bbox"][:n]
            gt[:n, 4] = r["gt_class"][:n]
        r["gt_bbox"] = gt
        return r


class ConvertImageFromHwcToChw(DetectionAugmentation):
    """No-op: the port runs NHWC batches (channels_last on the device)."""

    def apply(self, r):
        return r


class RenameRecord(DetectionAugmentation):
    def __init__(self, mapping):
        self.mapping = mapping

    def apply(self, r):
        for old, new in self.mapping.items():
            if old in r:
                r[new] = r.pop(old)
        return r


def apply_transforms(record, transforms):
    for t in transforms:
        t.apply(record)
    return record


TRANSFORMS = {cls.__name__: cls for cls in (
    ReadRoiRecord, Norm2DImage, Resize2DImageBbox, RandResize2DImageBbox,
    Flip2DImageBbox, Pad2DImageBbox, ConvertImageFromHwcToChw,
    RenameRecord)}


def _registry():
    """TRANSFORMS and the polygon transforms, by class name."""
    from simpledet_torch.data import mask_transforms as mt

    return dict(TRANSFORMS, **{cls.__name__: cls for cls in (
        mt.PreprocessGtPoly, mt.Resize2DImageBboxMask, mt.Flip2DImageBboxMask,
        mt.Pad2DImageBboxMask, mt.EncodeGtPoly)})


def from_config(recorded):
    """The port's transforms for a config's recorded transform list (each
    with `name`, `args` and `kwargs`, or a transform of this module that the
    config built itself); a transform not ported raises NotImplementedError
    naming it."""
    registry = _registry()
    out = []
    for t in recorded:
        if isinstance(t, DetectionAugmentation):
            out.append(t)
            continue
        cls = registry.get(t.name)
        if cls is None:
            raise NotImplementedError(f"transform {t.name!r} is not ported")
        out.append(cls(*t.args, **t.kwargs))
    return out
