"""JG303 fixture: data-dependent shapes inside a CUDA-graph capture
(parse-only). Translates tests/fixtures/graphlint/bad_shape_dynamic.py."""
import torch


def dynamic(mask, x, reps):
    idx = torch.nonzero(mask)  # expect: JG303
    hits = torch.where(mask)  # expect: JG303
    labels = torch.unique(x)  # expect: JG303
    picked = torch.masked_select(x, mask)  # expect: JG303
    coords = torch.argwhere(mask)  # expect: JG303
    pos = x[x > 0]  # expect: JG303
    live = (x > 1) & (x < 10)
    rest = x[live]  # expect: JG303
    rows = x.repeat_interleave(reps)  # expect: JG303
    first = mask.nonzero()  # expect: JG303
    return idx, hits, labels, picked, coords, pos, rest, rows, first


def fixed(mask, x, reps):
    # fixed-shape forms: must NOT fire
    sel = torch.where(mask, x, 0.0)
    rows = torch.repeat_interleave(x, reps, output_size=64)
    head = x[:4]
    gathered = x[reps.long()]
    return sel, rows, head, gathered


def capture(mask: torch.Tensor, x: torch.Tensor, reps: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = dynamic(mask, x, reps)
        kept = fixed(mask, x, reps)
    return g, out, kept
