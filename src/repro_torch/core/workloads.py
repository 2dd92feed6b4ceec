"""DNN workload descriptions for the analytical dataflow model.

The paper evaluates VGG16, VGG19, ResNet50, ResNet152 (ImageNet, 224x224).
Each workload is a list of layers with enough loop-nest structure for the
nn-dataflow-style performance model: Conv (C,K,H,W,R,S,stride) and GEMM
(M,N,K).  FC layers are GEMMs; transformer blocks (our beyond-paper
extension: sizing edge accelerators for LM workloads) decompose into GEMMs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    c_in: int
    c_out: int
    h_out: int
    w_out: int
    r: int = 3
    s: int = 3
    stride: int = 1

    @property
    def macs(self) -> int:
        return self.c_in * self.c_out * self.h_out * self.w_out * self.r * self.s

    @property
    def weight_bytes(self) -> int:  # int8 weights
        return self.c_in * self.c_out * self.r * self.s

    @property
    def ifmap_bytes(self) -> int:
        return self.c_in * (self.h_out * self.stride + self.r - 1) * \
            (self.w_out * self.stride + self.s - 1)

    @property
    def ofmap_bytes(self) -> int:
        return self.c_out * self.h_out * self.w_out


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    """C[M,N] = A[M,K] @ B[K,N]; B is the stationary (weight) operand."""
    name: str
    m: int
    n: int
    k: int

    @property
    def macs(self) -> int:
        return self.m * self.n * self.k

    @property
    def weight_bytes(self) -> int:
        return self.k * self.n

    @property
    def ifmap_bytes(self) -> int:
        return self.m * self.k

    @property
    def ofmap_bytes(self) -> int:
        return self.m * self.n


Layer = ConvLayer | GemmLayer


def _vgg(cfg: list[int | str], name: str) -> list[Layer]:
    layers: list[Layer] = []
    c_in, hw, idx = 3, 224, 1
    for v in cfg:
        if v == "M":
            hw //= 2
            continue
        layers.append(ConvLayer(f"{name}.conv{idx}", c_in, int(v), hw, hw))
        c_in = int(v)
        idx += 1
    layers.append(GemmLayer(f"{name}.fc1", 1, 4096, 512 * 7 * 7))
    layers.append(GemmLayer(f"{name}.fc2", 1, 4096, 4096))
    layers.append(GemmLayer(f"{name}.fc3", 1, 1000, 4096))
    return layers


def vgg16() -> list[Layer]:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"], "vgg16")


def vgg19() -> list[Layer]:
    return _vgg([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"], "vgg19")


def _resnet(blocks: list[int], name: str) -> list[Layer]:
    layers: list[Layer] = [ConvLayer(f"{name}.conv1", 3, 64, 112, 112, 7, 7, 2)]
    c_in = 64
    hw = 56
    widths = [64, 128, 256, 512]
    for stage, (nblk, w) in enumerate(zip(blocks, widths)):
        for b in range(nblk):
            stride = 2 if (stage > 0 and b == 0) else 1
            if stride == 2:
                hw //= 2
            tag = f"{name}.s{stage + 2}b{b}"
            layers.append(ConvLayer(f"{tag}.c1", c_in, w, hw, hw, 1, 1, stride))
            layers.append(ConvLayer(f"{tag}.c2", w, w, hw, hw, 3, 3, 1))
            layers.append(ConvLayer(f"{tag}.c3", w, 4 * w, hw, hw, 1, 1, 1))
            if b == 0:
                layers.append(ConvLayer(f"{tag}.proj", c_in, 4 * w, hw, hw,
                                        1, 1, stride))
            c_in = 4 * w
    layers.append(GemmLayer(f"{name}.fc", 1, 1000, 2048))
    return layers


def resnet50() -> list[Layer]:
    return _resnet([3, 4, 6, 3], "resnet50")


def resnet152() -> list[Layer]:
    return _resnet([3, 8, 36, 3], "resnet152")


def attn_block_gemms(name: str, d_model: int, d_ff: int, n_heads: int,
                     n_kv_heads: int, q_len: int, kv_len: int) -> list[Layer]:
    """One decoder block as GEMMs: `q_len` query tokens attending over
    `kv_len` cached positions.  `q_len == kv_len == seq` is a prefill /
    per-token-batch block; `q_len == 1` is a serving decode step."""
    head_dim = d_model // n_heads
    return [
        GemmLayer(f"{name}.q", q_len, n_heads * head_dim, d_model),
        GemmLayer(f"{name}.kv", q_len, 2 * n_kv_heads * head_dim, d_model),
        GemmLayer(f"{name}.scores", q_len * n_heads, kv_len, head_dim),
        GemmLayer(f"{name}.ctx", q_len * n_heads, head_dim, kv_len),
        GemmLayer(f"{name}.o", q_len, d_model, n_heads * head_dim),
        GemmLayer(f"{name}.up", q_len, 2 * d_ff, d_model),
        GemmLayer(f"{name}.down", q_len, d_model, d_ff),
    ]


def transformer_block_gemms(name: str, d_model: int, d_ff: int, n_heads: int,
                            n_kv_heads: int, seq: int) -> list[Layer]:
    """One decoder block as GEMMs (per-token batch = seq), for sizing edge
    accelerators on LM workloads (beyond-paper extension)."""
    return attn_block_gemms(name, d_model, d_ff, n_heads, n_kv_heads,
                            seq, seq)


def tiny_lm(seq: int = 128, layers: int = 4, d_model: int = 256) -> list[Layer]:
    out: list[Layer] = []
    for i in range(layers):
        out += transformer_block_gemms(f"lm.l{i}", d_model, 4 * d_model,
                                       8, 8, seq)
    return out


def decode_block_gemms(name: str, d_model: int, d_ff: int, n_heads: int,
                       n_kv_heads: int, kv_len: int) -> list[Layer]:
    """One decoder block for a SINGLE new token against a KV cache of
    `kv_len` entries — the serving engine's decode-step shape."""
    return attn_block_gemms(name, d_model, d_ff, n_heads, n_kv_heads,
                            1, kv_len)


def lm_decode(kv_len: int = 128, layers: int = 2, d_model: int = 256
              ) -> list[Layer]:
    """One decode step of the tiny LM (all blocks, fixed cache length):
    1/fps of this workload = per-token decode latency, the quantity the
    serving calibration bridge (`core/calibrate.py`) measures for real."""
    out: list[Layer] = []
    for i in range(layers):
        out += decode_block_gemms(f"lmdec.l{i}", d_model, 4 * d_model,
                                  8, 8, kv_len)
    return out


def lm_serving(prompt: int = 48, gen: int = 8, layers: int = 2,
               d_model: int = 256) -> list[Layer]:
    """One serving request end to end: a `prompt`-token prefill followed by
    `gen` decode steps against the growing KV cache — the layer-level
    mirror of one `serving.Engine` request, so scenario sweeps can size
    accelerators for LM serving traces, not just CNN frames.  1/fps =
    request latency."""
    out: list[Layer] = []
    for i in range(layers):
        out += transformer_block_gemms(f"lmsrv.pre.l{i}", d_model,
                                       4 * d_model, 8, 8, prompt)
    for t in range(gen):
        for i in range(layers):
            out += decode_block_gemms(f"lmsrv.d{t}.l{i}", d_model,
                                      4 * d_model, 8, 8, prompt + t + 1)
    return out


WORKLOADS = {
    "vgg16": vgg16,
    "vgg19": vgg19,
    "resnet50": resnet50,
    "resnet152": resnet152,
    "tiny_lm": tiny_lm,
    "lm_decode": lm_decode,
    "lm_serving": lm_serving,
}


def total_macs(layers: list[Layer]) -> int:
    return sum(l.macs for l in layers)
