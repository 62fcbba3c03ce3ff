"""What the metric files of the program's own spans share.

The program records its spans in one store a process
(`plonky2_bn254_tpu_torch.utils.timing.spans()`): each with an id, its
parent's and its root's id, a name, its seconds and `allocs`, the device
allocation requests made inside it.  The traced run turns tracing on with
the TimingTree each window proof opens, so the store holds the window's
proofs.  A metric selects spans by their root, since one name can sit under
several roots (the hook's inner `prove` has a "quotient" too), and takes
its mean over the roots of that name.  A program without the store (one
that predates it) reads as nothing: None.
"""

from __future__ import annotations


def program_spans():
    """The program's closed spans, or None where it keeps no store."""
    from plonky2_bn254_tpu_torch.utils import timing

    read = getattr(timing, "spans", None)
    return read() if read is not None else None


def roots(spans, name: str) -> list:
    return [s for s in spans if s.parent is None and s.name == name]


def mean_under(root_name: str, name: str):
    """The seconds of the spans `name` under each root `root_name`, summed
    a root, the mean over the roots that hold any."""
    spans = program_spans()
    if not spans:
        return None
    per_root = [[s.seconds for s in spans if s.root == r.id and s.name == name]
                for r in roots(spans, root_name)]
    per_root = [sum(v) for v in per_root if v]
    return sum(per_root) / len(per_root) if per_root else None


def mean_allocs(root_name: str):
    """The device allocation requests of each root `root_name`, the mean."""
    spans = program_spans()
    if not spans:
        return None
    counts = [r.allocs for r in roots(spans, root_name) if r.allocs is not None]
    return float(sum(counts)) / len(counts) if counts else None


def mean_self_s(root_name: str):
    """The self seconds of each root `root_name`, its seconds less its
    children's, the mean."""
    spans = program_spans()
    if not spans:
        return None
    selfs = [r.seconds - sum(s.seconds for s in spans if s.parent == r.id)
             for r in roots(spans, root_name)]
    return sum(selfs) / len(selfs) if selfs else None
