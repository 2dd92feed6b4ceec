"""Gate-level netlist model of an 8x8 signed (two's-complement) multiplier.

This is the substrate for the paper's *gate-level pruning* and *precision
scaling* approximation techniques [Balaskas et al., TCAS-I'22 — ref 5 of the
paper]: we build a modified Baugh-Wooley multiplier as an explicit boolean DAG
(AND/NAND partial products + Wallace-tree full/half adders + final ripple
carry), evaluate it exhaustively over all 65,536 input pairs with vectorized
numpy, and approximate it by

  * pruning: replacing any gate's output with its most-probable constant
    (signal-probability-directed pruning, as in [5]) and removing the gate --
    plus transitive dead-gate elimination of its now-unused fanin cone;
  * precision scaling: forcing the k LSBs of either operand to zero, which
    constant-propagates through the array and kills entire partial-product
    rows/columns (a special case of pruning).

Area is accounted in NAND2-equivalent units per gate type and converted to
um^2 with per-technology-node standard-cell constants (7/14/28 nm).

Everything here is plain numpy: the netlist engine is a design-time tool;
the GEMM side consumes its outputs (LUTs + low-rank error factors).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ----------------------------------------------------------------------------
# Gate model
# ----------------------------------------------------------------------------

# op codes
INPUT, CONST0, CONST1, NOT, AND, NAND, OR, NOR, XOR, XNOR = range(10)

OP_NAMES = {
    INPUT: "input", CONST0: "const0", CONST1: "const1", NOT: "not",
    AND: "and", NAND: "nand", OR: "or", NOR: "nor", XOR: "xor", XNOR: "xnor",
}

# Relative cell area in NAND2-equivalents (typical standard-cell library
# ratios; the absolute scale is set per technology node below).
GATE_AREA_NAND2EQ = {
    INPUT: 0.0, CONST0: 0.0, CONST1: 0.0,
    NOT: 0.67, NAND: 1.0, NOR: 1.0, AND: 1.33, OR: 1.33,
    XOR: 2.33, XNOR: 2.33,
}

# Approximate NAND2 cell area (um^2) per technology node.  Public-ballpark
# values (high-density std-cell libraries); only *ratios across nodes* matter
# for the paper's trends, absolute values set the die-area scale.
NAND2_UM2 = {7: 0.063, 14: 0.196, 28: 0.49}


@dataclasses.dataclass(frozen=True)
class Gate:
    op: int
    a: int = -1  # fanin node ids (-1 = unused)
    b: int = -1
    tag: str = ""  # debugging / structure tag, e.g. "pp_3_5", "fa_sum"


class Netlist:
    """A topologically-ordered boolean DAG with 16 primary product outputs."""

    def __init__(self) -> None:
        self.gates: list[Gate] = []
        self.outputs: list[int] = []  # 16 node ids, LSB first
        self.a_inputs: list[int] = []  # 8 node ids for operand a bits
        self.b_inputs: list[int] = []

    # -- construction -------------------------------------------------------
    def add(self, op: int, a: int = -1, b: int = -1, tag: str = "") -> int:
        self.gates.append(Gate(op, a, b, tag))
        return len(self.gates) - 1

    def num_gates(self) -> int:
        return len(self.gates)

    # -- evaluation ---------------------------------------------------------
    def evaluate(
        self,
        a_bits: np.ndarray,  # (8, N) uint8/bool — bit i of operand a
        b_bits: np.ndarray,
        pruned: dict[int, int] | None = None,  # node id -> forced const (0/1)
    ) -> np.ndarray:
        """Vectorized evaluation; returns (16, N) bool output bits."""
        pruned = pruned or {}
        n = a_bits.shape[1]
        vals: list[np.ndarray | None] = [None] * len(self.gates)
        false = np.zeros(n, dtype=bool)
        true = np.ones(n, dtype=bool)
        a_map = {nid: i for i, nid in enumerate(self.a_inputs)}
        b_map = {nid: i for i, nid in enumerate(self.b_inputs)}
        for nid, g in enumerate(self.gates):
            if nid in pruned:
                vals[nid] = true if pruned[nid] else false
                continue
            if g.op == INPUT:
                if nid in a_map:
                    vals[nid] = a_bits[a_map[nid]].astype(bool)
                else:
                    vals[nid] = b_bits[b_map[nid]].astype(bool)
            elif g.op == CONST0:
                vals[nid] = false
            elif g.op == CONST1:
                vals[nid] = true
            elif g.op == NOT:
                vals[nid] = ~vals[g.a]
            elif g.op == AND:
                vals[nid] = vals[g.a] & vals[g.b]
            elif g.op == NAND:
                vals[nid] = ~(vals[g.a] & vals[g.b])
            elif g.op == OR:
                vals[nid] = vals[g.a] | vals[g.b]
            elif g.op == NOR:
                vals[nid] = ~(vals[g.a] | vals[g.b])
            elif g.op == XOR:
                vals[nid] = vals[g.a] ^ vals[g.b]
            elif g.op == XNOR:
                vals[nid] = ~(vals[g.a] ^ vals[g.b])
            else:  # pragma: no cover
                raise ValueError(f"bad op {g.op}")
        return np.stack([vals[o] for o in self.outputs])

    # -- liveness / area ----------------------------------------------------
    def live_gates(self, pruned: dict[int, int] | None = None) -> set[int]:
        """Gates transitively reachable from outputs, not crossing pruned
        nodes (a pruned node is a constant: its fanin cone is dead unless
        reachable some other way)."""
        pruned = pruned or {}
        live: set[int] = set()
        stack = list(self.outputs)
        while stack:
            nid = stack.pop()
            if nid in live:
                continue
            live.add(nid)
            if nid in pruned:
                continue  # constant — do not traverse fanin
            g = self.gates[nid]
            if g.a >= 0:
                stack.append(g.a)
            if g.b >= 0:
                stack.append(g.b)
        return live

    def area_nand2eq(self, pruned: dict[int, int] | None = None) -> float:
        pruned = pruned or {}
        live = self.live_gates(pruned)
        total = 0.0
        for nid in live:
            if nid in pruned:
                continue  # replaced by a wire to vdd/gnd
            total += GATE_AREA_NAND2EQ[self.gates[nid].op]
        return total

    def area_um2(self, node_nm: int, pruned: dict[int, int] | None = None) -> float:
        return self.area_nand2eq(pruned) * NAND2_UM2[node_nm]

    def prunable_gates(self) -> list[int]:
        """Gate ids eligible for pruning: every logic gate (not inputs or
        constants)."""
        return [
            nid for nid, g in enumerate(self.gates)
            if g.op not in (INPUT, CONST0, CONST1)
        ]


# ----------------------------------------------------------------------------
# Adder cells (decomposed to gates, as synthesized netlists would be)
# ----------------------------------------------------------------------------

def _half_adder(nl: Netlist, x: int, y: int, tag: str) -> tuple[int, int]:
    s = nl.add(XOR, x, y, tag + ".s")
    c = nl.add(AND, x, y, tag + ".c")
    return s, c


def _full_adder(nl: Netlist, x: int, y: int, z: int, tag: str) -> tuple[int, int]:
    t = nl.add(XOR, x, y, tag + ".t")
    s = nl.add(XOR, t, z, tag + ".s")
    c1 = nl.add(AND, x, y, tag + ".c1")
    c2 = nl.add(AND, t, z, tag + ".c2")
    c = nl.add(OR, c1, c2, tag + ".c")
    return s, c


# ----------------------------------------------------------------------------
# Modified Baugh-Wooley 8x8 signed multiplier with Wallace reduction
# ----------------------------------------------------------------------------

def build_bw8_multiplier() -> Netlist:
    """8x8 two's-complement multiplier, 16-bit product.

    Modified Baugh-Wooley partial-product matrix for n=8:
      pp(i,j) = a_i AND b_j            for i<7, j<7 and (i,j)=(7,7)
      pp(7,j) = NOT(a_7 AND b_j)       for j<7   (NAND)
      pp(i,7) = NOT(a_i AND b_7)       for i<7   (NAND)
      plus constant 1 at bit 8 and constant 1 at bit 15.
    Reduced with a Wallace tree of the full/half adders above, finished by a
    ripple-carry stage.  Product taken mod 2^16 (exact for int8 x int8).
    """
    nl = Netlist()
    nl.a_inputs = [nl.add(INPUT, tag=f"a{i}") for i in range(8)]
    nl.b_inputs = [nl.add(INPUT, tag=f"b{j}") for j in range(8)]

    cols: list[list[int]] = [[] for _ in range(17)]
    for i in range(8):
        for j in range(8):
            inv = (i == 7) != (j == 7)  # exactly one sign bit -> NAND
            op = NAND if inv else AND
            nid = nl.add(op, nl.a_inputs[i], nl.b_inputs[j], f"pp_{i}_{j}")
            cols[i + j].append(nid)
    cols[8].append(nl.add(CONST1, tag="bw_k8"))
    cols[15].append(nl.add(CONST1, tag="bw_k15"))

    # Wallace reduction to <=2 bits per column.
    rnd = 0
    while any(len(c) > 2 for c in cols[:16]):
        new_cols: list[list[int]] = [[] for _ in range(17)]
        for w in range(16):
            bits = cols[w]
            k = 0
            while len(bits) - k >= 3:
                s, c = _full_adder(nl, bits[k], bits[k + 1], bits[k + 2],
                                   f"w{rnd}.fa{w}.{k}")
                new_cols[w].append(s)
                new_cols[w + 1].append(c)
                k += 3
            if len(bits) - k == 2 and len(bits) > 2:
                s, c = _half_adder(nl, bits[k], bits[k + 1], f"w{rnd}.ha{w}")
                new_cols[w].append(s)
                new_cols[w + 1].append(c)
                k += 2
            new_cols[w].extend(bits[k:])
        cols = new_cols
        rnd += 1

    # Final ripple-carry across the (<=2)-bit columns.
    outputs: list[int] = []
    carry: int | None = None
    for w in range(16):
        bits = list(cols[w])
        if carry is not None:
            bits.append(carry)
        if len(bits) == 0:
            outputs.append(nl.add(CONST0, tag=f"out{w}.z"))
            carry = None
        elif len(bits) == 1:
            outputs.append(bits[0])
            carry = None
        elif len(bits) == 2:
            s, c = _half_adder(nl, bits[0], bits[1], f"rc.ha{w}")
            outputs.append(s)
            carry = c
        else:  # 3
            s, c = _full_adder(nl, bits[0], bits[1], bits[2], f"rc.fa{w}")
            outputs.append(s)
            carry = c
    nl.outputs = outputs
    return nl


# ----------------------------------------------------------------------------
# Exhaustive evaluation -> LUT
# ----------------------------------------------------------------------------

def _all_input_bits() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All 65,536 (a, b) int8 pairs as bit arrays.

    Returns (a_bits (8, 65536), b_bits, a_vals (65536,), b_vals)."""
    ua = np.arange(256, dtype=np.uint16)
    aa, bb = np.meshgrid(ua, ua, indexing="ij")
    aa = aa.ravel()
    bb = bb.ravel()
    a_bits = np.stack([(aa >> i) & 1 for i in range(8)]).astype(bool)
    b_bits = np.stack([(bb >> i) & 1 for i in range(8)]).astype(bool)
    a_vals = aa.astype(np.uint8).view(np.int8).astype(np.int32)
    b_vals = bb.astype(np.uint8).view(np.int8).astype(np.int32)
    return a_bits, b_bits, a_vals, b_vals


_INPUT_CACHE: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None = None


def all_input_bits() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    global _INPUT_CACHE
    if _INPUT_CACHE is None:
        _INPUT_CACHE = _all_input_bits()
    return _INPUT_CACHE


def bits_to_int16(out_bits: np.ndarray) -> np.ndarray:
    """(16, N) bool -> (N,) int32 interpreting two's-complement int16."""
    acc = np.zeros(out_bits.shape[1], dtype=np.uint32)
    for w in range(16):
        acc |= out_bits[w].astype(np.uint32) << w
    return acc.astype(np.uint16).view(np.int16).astype(np.int32)


_PACKED_CACHE: tuple[np.ndarray, np.ndarray] | None = None


def _packed_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Bit-packed (8, 1024)-uint64 input planes for 64x faster evaluation."""
    global _PACKED_CACHE
    if _PACKED_CACHE is None:
        a_bits, b_bits, _, _ = all_input_bits()
        def pack(x: np.ndarray) -> np.ndarray:
            u8 = np.packbits(x, axis=1, bitorder="little")
            return u8.view(np.uint64)
        _PACKED_CACHE = (pack(a_bits), pack(b_bits))
    return _PACKED_CACHE


def evaluate_packed(nl: Netlist, pruned: dict[int, int] | None = None
                    ) -> np.ndarray:
    """Exhaustive evaluation over all 65,536 pairs using uint64 bit-packing.

    Returns (16, 65536) bool output bits; ~20-60x faster than bool arrays.
    """
    pruned = pruned or {}
    a_pk, b_pk = _packed_inputs()
    nwords = a_pk.shape[1]
    zeros = np.zeros(nwords, dtype=np.uint64)
    ones = np.full(nwords, np.uint64(0xFFFFFFFFFFFFFFFF))
    vals: list[np.ndarray | None] = [None] * len(nl.gates)
    a_map = {nid: i for i, nid in enumerate(nl.a_inputs)}
    b_map = {nid: i for i, nid in enumerate(nl.b_inputs)}
    for nid, g in enumerate(nl.gates):
        if nid in pruned:
            vals[nid] = ones if pruned[nid] else zeros
            continue
        op = g.op
        if op == INPUT:
            vals[nid] = a_pk[a_map[nid]] if nid in a_map else b_pk[b_map[nid]]
        elif op == CONST0:
            vals[nid] = zeros
        elif op == CONST1:
            vals[nid] = ones
        elif op == NOT:
            vals[nid] = ~vals[g.a]
        elif op == AND:
            vals[nid] = vals[g.a] & vals[g.b]
        elif op == NAND:
            vals[nid] = ~(vals[g.a] & vals[g.b])
        elif op == OR:
            vals[nid] = vals[g.a] | vals[g.b]
        elif op == NOR:
            vals[nid] = ~(vals[g.a] | vals[g.b])
        elif op == XOR:
            vals[nid] = vals[g.a] ^ vals[g.b]
        else:  # XNOR
            vals[nid] = ~(vals[g.a] ^ vals[g.b])
    out = np.stack([vals[o] for o in nl.outputs])
    u8 = out.view(np.uint8)
    return np.unpackbits(u8, axis=1, bitorder="little").astype(bool)


def netlist_lut(nl: Netlist, pruned: dict[int, int] | None = None) -> np.ndarray:
    """(256, 256) int32 LUT indexed by [a & 0xFF, b & 0xFF]."""
    out = evaluate_packed(nl, pruned)
    return bits_to_int16(out).reshape(256, 256)


def exact_lut() -> np.ndarray:
    """(256, 256) int32 exact signed product LUT, same indexing."""
    _, _, a_vals, b_vals = all_input_bits()
    return (a_vals * b_vals).reshape(256, 256)


def signal_probabilities(nl: Netlist) -> np.ndarray:
    """P(gate output == 1) under uniform inputs, for prune-constant choice."""
    a_bits, b_bits, _, _ = all_input_bits()
    n = a_bits.shape[1]
    vals: list[np.ndarray | None] = [None] * len(nl.gates)
    probs = np.zeros(len(nl.gates))
    false = np.zeros(n, dtype=bool)
    true = np.ones(n, dtype=bool)
    a_map = {nid: i for i, nid in enumerate(nl.a_inputs)}
    b_map = {nid: i for i, nid in enumerate(nl.b_inputs)}
    for nid, g in enumerate(nl.gates):
        if g.op == INPUT:
            vals[nid] = a_bits[a_map[nid]] if nid in a_map else b_bits[b_map[nid]]
            vals[nid] = vals[nid].astype(bool)
        elif g.op == CONST0:
            vals[nid] = false
        elif g.op == CONST1:
            vals[nid] = true
        elif g.op == NOT:
            vals[nid] = ~vals[g.a]
        elif g.op == AND:
            vals[nid] = vals[g.a] & vals[g.b]
        elif g.op == NAND:
            vals[nid] = ~(vals[g.a] & vals[g.b])
        elif g.op == OR:
            vals[nid] = vals[g.a] | vals[g.b]
        elif g.op == NOR:
            vals[nid] = ~(vals[g.a] | vals[g.b])
        elif g.op == XOR:
            vals[nid] = vals[g.a] ^ vals[g.b]
        elif g.op == XNOR:
            vals[nid] = ~(vals[g.a] ^ vals[g.b])
        probs[nid] = float(np.mean(vals[nid]))
    return probs


def truncation_pruning(nl: Netlist, trunc_a: int, trunc_b: int) -> dict[int, int]:
    """Precision scaling as input forcing: k LSBs of each operand -> 0."""
    pruned: dict[int, int] = {}
    for i in range(min(trunc_a, 8)):
        pruned[nl.a_inputs[i]] = 0
    for j in range(min(trunc_b, 8)):
        pruned[nl.b_inputs[j]] = 0
    return pruned


def constant_propagate(nl: Netlist, pruned: dict[int, int]) -> dict[int, int]:
    """Extend a pruning assignment with every gate whose output becomes
    constant under it (so dead-gate elimination credits the full savings of
    e.g. truncated partial-product rows)."""
    const: dict[int, int] = dict(pruned)
    for nid, g in enumerate(nl.gates):
        if nid in const:
            continue
        if g.op == CONST0:
            const[nid] = 0
        elif g.op == CONST1:
            const[nid] = 1
        elif g.op == NOT and g.a in const:
            const[nid] = 1 - const[g.a]
        elif g.op in (AND, NAND):
            ca, cb = const.get(g.a), const.get(g.b)
            if ca == 0 or cb == 0:
                const[nid] = 1 if g.op == NAND else 0
            elif ca == 1 and cb == 1:
                const[nid] = 0 if g.op == NAND else 1
        elif g.op in (OR, NOR):
            ca, cb = const.get(g.a), const.get(g.b)
            if ca == 1 or cb == 1:
                const[nid] = 0 if g.op == NOR else 1
            elif ca == 0 and cb == 0:
                const[nid] = 1 if g.op == NOR else 0
        elif g.op in (XOR, XNOR):
            ca, cb = const.get(g.a), const.get(g.b)
            if ca is not None and cb is not None:
                v = ca ^ cb
                const[nid] = (1 - v) if g.op == XNOR else v
    # Only keep entries that are *constants*; inputs forced by caller stay.
    return const


def self_check() -> None:
    """Assert the exact netlist reproduces int8 x int8 for all pairs."""
    nl = build_bw8_multiplier()
    lut = netlist_lut(nl)
    if not np.array_equal(lut, exact_lut()):
        bad = np.argwhere(lut != exact_lut())
        raise AssertionError(
            f"BW8 netlist mismatch at {len(bad)} entries, first {bad[:4]}")


_BW8_CACHE: Netlist | None = None


def bw8() -> Netlist:
    """Cached exact 8x8 Baugh-Wooley netlist (verified on first build)."""
    global _BW8_CACHE
    if _BW8_CACHE is None:
        nl = build_bw8_multiplier()
        _BW8_CACHE = nl
    return _BW8_CACHE
