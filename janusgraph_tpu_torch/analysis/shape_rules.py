"""JG3xx padding/shape-invariant rules for the kernel layers.

JG301  capacity tiers (`E_cap`/`F_cap`/`*_capacity`/`E_MIN`/`F_MIN`/
       `MAX_EDGES`, and the hybrid tail's `tail_chunk`/`*_chunk`/
       `chunk_width` static tail-capacity tiers) must be power-of-two
       integer literals. The ELL packer buckets by next-pow2 degree
       (bounded <2x padding), the frontier engine's tier ladder reuses one
       executable per power tier, and the hybrid tail's chunk width must
       divide every hub row's pow2 tree width so chunks stay aligned
       subtrees (the bitwise-identity contract, olap/kernels.py
       tree_reduce) — a non-pow2 literal breaks all three contracts
       silently.
JG302  integer-dtype `full(...)` padding with a bare literal fill (other
       than 0/1/-1): padded slots must read the *documented sentinel* (a
       named constant like `pack.sentinel` or `INF`), otherwise a sentinel
       drift between packer and kernel reads garbage neighbors.
JG303  data-dependent output shapes inside a CUDA-graph capture context:
       `nonzero`/`argwhere`/`unique`/`unique_consecutive`/`masked_select`,
       one-argument `where`, boolean-mask indexing (`x[x > 0]`, `x[mask]`
       with `mask` built from a comparison), `repeat_interleave` without
       `output_size=` — each sizes its output on the host (a sync the
       capture cannot hold, or a shape frozen at capture); captured bodies
       keep fixed shapes (`torch.where(mask, x, identity)`, a static
       capacity and padding).
JG304  feature-dim padding tiers (`d_pad`/`*_dim_pad`/`dim_tier`/
       `*_dim_tier`/`feature_tier`/`lane_width`/`lane_tier`) must be
       power-of-two integer literals (or 0 = auto-pick). The dense-feature
       tier pads [n, d] blocks to pow2 lane tiers (FEATURE_TIERS) so the
       SDDMM tree-dot and dense-transform tree-matmul contract over
       complete adjacent-pair trees (the bitwise contract) and rows stay
       VPU/MXU lane-aligned — a non-pow2 padded width raises at runtime in
       tree_dot/tree_matmul and silently mis-tiles before it gets there.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from janusgraph_tpu_torch.analysis.core import Finding, RULES
from janusgraph_tpu_torch.analysis.tracing import find_traced_defs, terminal_name

_CAP_NAME_RE = re.compile(
    r"^[ef]_?(cap|min)$|_cap$|_capacity$|^max_edges$|^max_capacity$"
    r"|_chunk$|^chunk_width$|^tail_chunk$",
    re.IGNORECASE,
)

#: propagation-blocked halo-exchange tiers (parallel/halo.py): per-pair
#: merged-destination bins pad to one pow2 capacity tier so a single
#: all_to_all split (and one compiled executable) serves every graph
#: whose halo fits the tier — a non-pow2 literal silently breaks the
#: uniform-split contract AND the tier-reuse economics. 0 = auto-pick
#: (halo_tier derives the tier from the widest pair), allowed.
_HALO_NAME_RE = re.compile(
    r"_bin$|^halo_cap$|_halo_cap$|^exchange_tier$|_exchange_tier$",
    re.IGNORECASE,
)

#: delta-CSR overlay tiers (olap/delta.py): the fused lanes and the
#: extra-vertex domain pad to pow2 capacity tiers so ONE compiled
#: superstep executable serves every overlay that fits the tier — a
#: non-pow2 literal breaks the tier-reuse economics and the static-shape
#: contract silently. 0 = auto-pick (overlay_tier derives the tier from
#: the lane size), allowed.
_DELTA_NAME_RE = re.compile(
    r"^delta_cap$|_delta_cap$|^overlay_tier$|_overlay_tier$|_delta_bin$",
    re.IGNORECASE,
)

#: dense-tier padded feature-dim names. The LOGICAL dim (feature_dim,
#: hidden_dim, ...) may be any value — only the PADDED tier the kernels
#: consume must be a lane-width pow2 (0 = auto-pick, allowed).
_FEATURE_TIER_RE = re.compile(
    r"^d_pad$|_dim_pad$|^dim_tier$|_dim_tier$|^feature_tier$"
    r"|^lane_width$|^lane_tier$",
    re.IGNORECASE,
)

_SHAPE_ESCAPE_FNS = {
    "nonzero", "unique", "unique_consecutive", "argwhere", "masked_select",
}

#: calls whose result is a boolean mask
_MASK_FNS = {
    "isnan", "isinf", "isfinite", "isposinf", "isneginf", "isin",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "eq", "ne", "lt", "le", "gt", "ge", "bool",
}


def _finding(rule: str, mod, node, message: str) -> Finding:
    return Finding(
        rule, RULES[rule].severity, mod.path,
        getattr(node, "lineno", 1), getattr(node, "col_offset", 0), message,
    )


def _const_int(node: ast.AST) -> Optional[int]:
    """Fold the literal int forms tiers are written in: 123, 1 << 14,
    2 ** 10, 4 * 1024, -(-x // y) is NOT folded (non-literal)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        left, right = _const_int(node.left), _const_int(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.LShift):
            return left << right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Pow):
            return left ** right
        if isinstance(node.op, ast.Add):
            return left + right
    return None


def _is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def _check_capacity_tiers(mod) -> List[Finding]:
    out: List[Finding] = []

    def check(name: str, value_node: ast.AST, where: ast.AST):
        if _DELTA_NAME_RE.search(name):
            v = _const_int(value_node)
            # 0 = auto-pick (overlay_tier sizes from the lane); only an
            # explicit non-pow2 tier is the bug
            if v is None or v == 0 or _is_pow2(v):
                return
            out.append(_finding(
                "JG301", mod, where,
                f"delta-overlay capacity tier `{name}` = {v} is not a "
                f"power of two — overlay lanes and the extra-vertex "
                f"domain pad to pow2 tiers so one compiled superstep "
                f"executable serves every overlay that fits (use 0 to "
                f"auto-pick via overlay_tier)",
            ))
            return
        if _FEATURE_TIER_RE.search(name):
            v = _const_int(value_node)
            # 0 = auto-pick (pick_feature_tier walks the FEATURE_TIERS
            # ladder); only an explicit non-pow2 tier is the bug
            if v is None or v == 0 or _is_pow2(v):
                return
            out.append(_finding(
                "JG304", mod, where,
                f"feature-dim padding tier `{name}` = {v} is not a power "
                f"of two — dense-tier feature blocks pad to pow2 lane "
                f"tiers so tree_dot/tree_matmul reduce complete trees "
                f"(use 0 to auto-pick from FEATURE_TIERS)",
            ))
            return
        if _HALO_NAME_RE.search(name):
            v = _const_int(value_node)
            # 0 = auto-pick (halo_tier sizes the bin from the widest
            # cross-shard pair); only an explicit non-pow2 tier is the bug
            if v is None or v == 0 or _is_pow2(v):
                return
            out.append(_finding(
                "JG301", mod, where,
                f"halo-bin capacity tier `{name}` = {v} is not a power "
                f"of two — blocked-exchange bins pad to pow2 tiers so "
                f"one all_to_all split (and one compiled executable) "
                f"serves every graph whose halo fits the tier (use 0 to "
                f"auto-pick via halo_tier)",
            ))
            return
        if not _CAP_NAME_RE.search(name):
            return
        v = _const_int(value_node)
        if v is None or _is_pow2(v):
            return
        out.append(_finding(
            "JG301", mod, where,
            f"capacity tier `{name}` = {v} is not a power of two — ELL "
            f"bucketing and frontier-tier executable reuse require "
            f"power-of-two capacities",
        ))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    check(t.id, node.value, node)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                check(node.target.id, node.value, node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            pos = args.posonlyargs + args.args
            for arg, default in zip(pos[len(pos) - len(args.defaults):], args.defaults):
                check(arg.arg, default, default)
            for arg, default in zip(args.kwonlyargs, args.kw_defaults):
                if default is not None:
                    check(arg.arg, default, default)
    return out


def _dtype_is_int(call: ast.Call) -> Optional[bool]:
    """True/False when the `full` call's dtype is recognizably int/float;
    None when absent or unrecognizable."""
    dtype = None
    if len(call.args) >= 3:
        dtype = call.args[2]
    for kw in call.keywords:
        if kw.arg == "dtype":
            dtype = kw.value
    if dtype is None:
        return None
    t = terminal_name(dtype)
    if t is None:
        return None
    if "int" in t.lower():
        return True
    if "float" in t.lower() or "bfloat" in t.lower() or "complex" in t.lower():
        return False
    return None


def _check_sentinel_fills(mod) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if terminal_name(node.func) != "full" or len(node.args) < 2:
            continue
        fill = node.args[1]
        v = _const_int(fill)
        if v is None or v in (0, 1, -1):
            continue
        if _dtype_is_int(node) is False:
            continue  # float-dtype fills are not index padding
        out.append(_finding(
            "JG302", mod, node,
            f"integer padding fill uses bare literal {v} — use the "
            f"documented sentinel name (e.g. `pack.sentinel`, the "
            f"one-past-the-end identity slot) so packer and kernel can "
            f"never drift",
        ))
    return out


def _is_mask(node: ast.AST, masks) -> bool:
    """Is the expression a boolean mask: a comparison, ``~``/``&``/``|``/
    ``^`` of masks, a mask-valued call, or a name bound to one?"""
    if isinstance(node, ast.Compare):
        return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                       for op in node.ops)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand, masks)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return _is_mask(node.left, masks) or _is_mask(node.right, masks)
    if isinstance(node, ast.Call):
        return terminal_name(node.func) in _MASK_FNS
    if isinstance(node, ast.Name):
        return node.id in masks
    return False


def _check_dynamic_shapes(mod, traced) -> List[Finding]:
    out: List[Finding] = []
    for td in traced.values():
        name = td.name
        masks = set()
        for sub in ast.walk(td.node):
            if (
                isinstance(sub, ast.Assign) and len(sub.targets) == 1
                and isinstance(sub.targets[0], ast.Name)
                and _is_mask(sub.value, masks)
            ):
                masks.add(sub.targets[0].id)
        for sub in ast.walk(td.node):
            if (
                isinstance(sub, ast.Subscript)
                and isinstance(sub.ctx, ast.Load)
                and _is_mask(sub.slice, masks)
            ):
                out.append(_finding(
                    "JG303", mod, sub,
                    f"boolean-mask indexing `{ast.unparse(sub)}` in capture "
                    f"context `{name}` — the output shape is data-dependent; "
                    f"use torch.where with the monoid identity to keep it "
                    f"fixed-shape",
                ))
                continue
            if not isinstance(sub, ast.Call):
                continue
            t = terminal_name(sub.func)
            if t in _SHAPE_ESCAPE_FNS:
                out.append(_finding(
                    "JG303", mod, sub,
                    f"`{t}` in capture context `{name}` — the output shape "
                    f"is data-dependent (sized on the host); keep a static "
                    f"capacity and pad, or move it before the capture",
                ))
            elif t == "where" and len(sub.args) == 1 and not sub.keywords:
                out.append(_finding(
                    "JG303", mod, sub,
                    f"one-argument `where` in capture context `{name}` — "
                    f"data-dependent shape; use the three-argument form",
                ))
            elif t == "repeat_interleave" and not any(
                kw.arg == "output_size" for kw in sub.keywords
            ):
                out.append(_finding(
                    "JG303", mod, sub,
                    f"`repeat_interleave` without output_size= in capture "
                    f"context `{name}` — the output length is summed on "
                    f"the host; pass output_size=",
                ))
    return out


def check_module(mod, traced=None) -> List[Finding]:
    if traced is None:
        traced = find_traced_defs(mod)
    out = _check_capacity_tiers(mod)
    out.extend(_check_sentinel_fills(mod))
    out.extend(_check_dynamic_shapes(mod, traced))
    return out
