"""Hand-written CUDA kernels of the port and their plain versions.

K1 ``wilson_hop`` and K4 ``wilson_full`` (:mod:`.wilson_dslash`), K2
``cg_update`` and K3 ``cg_xpay`` (:mod:`.cg_fused`); :mod:`.build`
compiles ``csrc/*.cu``.  Each kernel has a float32, a bf16 and a float16
instance.
Nothing is built or imported from ``nvcc`` until a kernel is launched.
"""

from repro_torch.kernels import build
from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
from repro_torch.kernels.wilson_dslash.kernel import wilson_full, wilson_hop

WRAPPERS = {"wilson_hop": wilson_hop, "cg_update": cg_update,
            "cg_xpay": cg_xpay, "wilson_full": wilson_full}


def reset_counts() -> None:
    """Set every wrapper's launch and plain-call counts to 0."""
    for fn in WRAPPERS.values():
        build.zero_counts(fn)


NARROW = ("_bf16", "_f16")   # the narrow instances' count suffixes


def pair_launches() -> dict[str, int]:
    """{kernel: n} since the last reset: the launches of the Wilson
    kernels' pair instances, a part of their ``<kernel>_bf16`` and
    ``<kernel>_f16`` launches (the rest ran the one-site instance)."""
    return {name + sfx: getattr(WRAPPERS[name], f"launches{sfx}_pair")
            for name in ("wilson_hop", "wilson_full") for sfx in NARROW}


def counts() -> dict[str, dict[str, int]]:
    """{kernel: {"launches": n, "plain_calls": m}} since the last reset,
    with the bf16 and float16 instances as ``<kernel>_bf16`` and
    ``<kernel>_f16``."""
    out = {}
    for name, fn in WRAPPERS.items():
        out[name] = {"launches": fn.launches, "plain_calls": fn.plain_calls}
        for sfx in NARROW:
            out[name + sfx] = {"launches": getattr(fn, "launches" + sfx),
                               "plain_calls": getattr(fn, "plain_calls"
                                                      + sfx)}
    return out
