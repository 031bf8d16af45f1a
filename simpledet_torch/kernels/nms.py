"""Greedy-NMS keep mask: the CUDA bitmask kernel and its plain version.

Replaces `simpledet_tpu/kernels/nms_pallas.py::_nms_kernel`. The kernel
(`csrc/nms.cu`) writes the 64 x 64 tiles of u64 suppression words on or right
of the diagonal for every problem in one launch, then resolves each problem
block by block in one CTA (ffs over each block's candidates, one step per kept
row); its note says what bounds it. A CPU tensor goes to
`nms_keep_sorted_plain`; a CUDA tensor launches the kernel or raises.
"""
import ctypes

import torch

from simpledet_torch.kernels import _build

launches = 0   # kernel launches since the caller last set this to 0


def pair_suppression(boxes, valid, thr):
    """[P, N, N] bool: row box i suppresses column box j (j > i, both valid).

    IoU with legacy +1 widths as inter / max(union, 1e-12), each operation
    rounded as the kernel rounds it."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :]) + 1.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    n = boxes.shape[1]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    thr32 = torch.tensor(thr, dtype=torch.float32, device=boxes.device)
    return (iou > thr32) & later & valid[:, :, None] & valid[:, None, :]


def nms_keep_sorted_plain(sorted_boxes, sorted_valid, thr):
    """Plain PyTorch keep mask: [P, N, 4] f32 boxes sorted by descending score,
    [P, N] bool valid -> [P, N] bool keep.

    Greedy NMS's keep set is the unique fixpoint of the antitone map
    f(K)[i] = valid[i] and not any_{j<i}(K[j] and sup[j, i]); iterating f from
    all-true reaches it in (longest suppression chain + 1) steps, as in
    `simpledet_tpu/ops/nms.py::nms_keep_sorted_fixpoint`.
    """
    sup = pair_suppression(sorted_boxes, sorted_valid, thr)
    keep = sorted_valid.clone()
    for _ in range(sorted_boxes.shape[1] + 1):
        nxt = sorted_valid & ~(sup & keep[:, :, None]).any(dim=1)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return keep


def nms_keep_sorted(sorted_boxes, sorted_valid, thr):
    """Keep mask for [P, N, 4] f32 sorted boxes and [P, N] bool valid flags:
    one launch pair for all P problems on CUDA, the plain version on CPU."""
    global launches
    if sorted_boxes.device.type == "cpu":
        return nms_keep_sorted_plain(sorted_boxes, sorted_valid, thr)
    if sorted_boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_sorted: unsupported device "
                         f"{sorted_boxes.device}")
    p, n = sorted_valid.shape
    if (sorted_boxes.dtype != torch.float32 or sorted_valid.dtype != torch.bool
            or sorted_boxes.shape != (p, n, 4)
            or sorted_valid.device != sorted_boxes.device):
        raise ValueError("nms_keep_sorted: want boxes [P, N, 4] float32 and "
                         "valid [P, N] bool on one device")
    lib = _lib()
    if n > lib.simpledet_nms_max_n() or p > 65535:
        raise ValueError(f"nms_keep_sorted: at most 65535 problems of "
                         f"{lib.simpledet_nms_max_n()} boxes, got {p} x {n}")
    boxes = sorted_boxes.contiguous()
    valid = sorted_valid.contiguous()
    keep = torch.empty((p, n), dtype=torch.bool, device=boxes.device)
    mask = torch.empty((p, lib.simpledet_nms_mask_words(n)),
                       dtype=torch.int64, device=boxes.device)
    err = lib.simpledet_nms_keep(
        boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
        p, n, thr, torch.cuda.current_stream(boxes.device).cuda_stream)
    launches += 1
    _build.check(lib, err, "nms_keep_sorted")
    return keep


def _lib():
    lib = _build.load("nms")
    fn = lib.simpledet_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.simpledet_nms_max_n.argtypes = []
    lib.simpledet_nms_max_n.restype = ctypes.c_int
    lib.simpledet_nms_mask_words.argtypes = [ctypes.c_int]
    lib.simpledet_nms_mask_words.restype = ctypes.c_longlong
    return lib
