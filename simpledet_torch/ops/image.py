"""Device-side image normalisation (counterpart of simpledet_tpu/ops/image.py).

The host keeps pixels uint8 NHWC; (x - mean) / std runs on the device. The
reference pads AFTER normalising, so padded pixels are 0 in normalised space:
the border beyond im_info's (h', w') is re-zeroed here.
"""
import torch


def device_normalize(data, im_info, mean, std):
    """data [B, H, W, 3] uint8 (float input is returned as is); im_info [B, 3]
    = (h', w', scale). Returns float32 [B, H, W, 3] with the border zeroed."""
    if data.dtype != torch.uint8:
        return data
    mean = torch.as_tensor(mean, dtype=torch.float32, device=data.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=data.device)
    x = (data.to(torch.float32) - mean) / std
    h, w = data.shape[1:3]
    rows = torch.arange(h, dtype=torch.float32, device=data.device)
    cols = torch.arange(w, dtype=torch.float32, device=data.device)
    row_ok = rows[None, :] < im_info[:, 0:1]
    col_ok = cols[None, :] < im_info[:, 1:2]
    mask = row_ok[:, :, None] & col_ok[:, None, :]
    return torch.where(mask[..., None], x, torch.zeros((), device=data.device))
