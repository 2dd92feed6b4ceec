"""CNNs for the paper's own evaluation (VGG16/19, ResNet50/152) plus small
trainable variants for the accuracy-drop calibration experiments.

NHWC, conv via repro_torch.approx.layers.conv2d (im2col + approximate GEMM
when a multiplier spec is active — exactly how the NVDLA-style accelerator
maps conv onto its MAC array).  BN is folded (inference-style affine),
matching post-training int8 deployment.  Parameters are the JAX package's
trees (lists of per-layer dicts) with tensors for arrays.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.approx import layers as AL
from repro_torch.device import resolve_device

Params = dict[str, Any]

VGG_CFG = {
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
    "vgg_mini": [16, "M", 32, "M", 64, "M"],   # for 32x32 calibration runs
}


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def init_vgg(arch: str, seed: int = 0, n_classes: int = 1000,
             in_ch: int = 3, image: int = 224, dtype=torch.float32,
             device: str | torch.device | None = None) -> Params:
    """Random params from a seeded `torch.Generator` on `device`."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params: Params = {"convs": [], "fcs": []}
    c_in, hw = in_ch, image
    for v in VGG_CFG[arch]:
        if v == "M":
            hw //= 2
            continue
        params["convs"].append({
            "w": _normal(gen, (3, 3, c_in, v), (9 * c_in) ** -0.5, dtype),
            "b": torch.zeros((v,), dtype=dtype, device=gen.device)})
        c_in = v
    flat = c_in * hw * hw
    dims = [4096, 4096, n_classes] if arch != "vgg_mini" else [128, n_classes]
    for dout in dims:
        params["fcs"].append({
            "w": _normal(gen, (flat, dout), flat ** -0.5, dtype),
            "b": torch.zeros((dout,), dtype=dtype, device=gen.device)})
        flat = dout
    return params


def _max_pool(x: torch.Tensor, k: int, stride: int, same: bool
              ) -> torch.Tensor:
    """NHWC max-pool.  VALID floors like `lax.reduce_window`; SAME pads
    with -inf as XLA does: (total // 2) before, the rest after — for an even
    size at stride 2 that is (0, 1), which no symmetric `padding=` of
    F.max_pool2d gives."""
    xc = x.permute(0, 3, 1, 2)
    if same:
        pads = []
        for size in (x.shape[2], x.shape[1]):          # F.pad: last dim first
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        xc = F.pad(xc, pads, value=float("-inf"))
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def vgg_forward(params: Params, x: torch.Tensor, arch: str, spec=None
                ) -> torch.Tensor:
    ci = 0
    for v in VGG_CFG[arch]:
        if v == "M":
            x = _max_pool(x, 2, 2, same=False)
            continue
        p = params["convs"][ci]
        x = torch.relu(AL.conv2d(x, p["w"], 1, 1, spec) + p["b"])
        ci += 1
    x = x.reshape(x.shape[0], -1)
    for i, p in enumerate(params["fcs"]):
        x = AL.dense(x, p["w"], p["b"], spec)
        if i < len(params["fcs"]) - 1:
            x = torch.relu(x)
    return x


RESNET_BLOCKS = {"resnet50": [3, 4, 6, 3], "resnet152": [3, 8, 36, 3],
                 "resnet_mini": [1, 1]}


def init_resnet(arch: str, seed: int = 0, n_classes: int = 1000,
                dtype=torch.float32,
                device: str | torch.device | None = None) -> Params:
    """Random params from a seeded `torch.Generator` on `device`."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    blocks = RESNET_BLOCKS[arch]
    mini = arch == "resnet_mini"
    widths = [16, 32] if mini else [64, 128, 256, 512]
    expansion = 2 if mini else 4

    def conv(cin, cout, k):
        return {"w": _normal(gen, (k, k, cin, cout), (k * k * cin) ** -0.5,
                             dtype),
                "s": torch.ones((cout,), dtype=dtype, device=gen.device),
                "b": torch.zeros((cout,), dtype=dtype, device=gen.device)}

    params: Params = {"stem": conv(3, widths[0], 3 if mini else 7),
                      "stages": []}
    c_in = widths[0]
    for nblk, w in zip(blocks, widths):
        stage_p = []
        for b in range(nblk):
            blk = {"c1": conv(c_in, w, 1), "c2": conv(w, w, 3),
                   "c3": conv(w, w * expansion, 1)}
            if b == 0:
                blk["proj"] = conv(c_in, w * expansion, 1)
            stage_p.append(blk)
            c_in = w * expansion
        params["stages"].append(stage_p)
    params["fc"] = {"w": _normal(gen, (c_in, n_classes), c_in ** -0.5, dtype),
                    "b": torch.zeros((n_classes,), dtype=dtype,
                                     device=gen.device)}
    return params


def _affine(x, p):
    return x * p["s"] + p["b"]


def resnet_forward(params: Params, x: torch.Tensor, arch: str, spec=None
                   ) -> torch.Tensor:
    mini = arch == "resnet_mini"
    stem = params["stem"]
    x = AL.conv2d(x, stem["w"], 1 if mini else 2, 1 if mini else 3, spec)
    x = torch.relu(_affine(x, stem))
    if not mini:
        x = _max_pool(x, 3, 2, same=True)
    for stage_i, stage in enumerate(params["stages"]):
        for b_i, blk in enumerate(stage):
            stride = 2 if (stage_i > 0 and b_i == 0) else 1
            y = torch.relu(_affine(
                AL.conv2d(x, blk["c1"]["w"], stride, 0, spec), blk["c1"]))
            y = torch.relu(_affine(
                AL.conv2d(y, blk["c2"]["w"], 1, 1, spec), blk["c2"]))
            y = _affine(AL.conv2d(y, blk["c3"]["w"], 1, 0, spec), blk["c3"])
            if "proj" in blk:
                x = _affine(AL.conv2d(x, blk["proj"]["w"], stride, 0, spec),
                            blk["proj"])
            x = torch.relu(x + y)
    x = x.mean(dim=(1, 2))
    return AL.dense(x, params["fc"]["w"], params["fc"]["b"], spec)
