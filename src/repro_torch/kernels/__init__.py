"""Hand-written CUDA kernels of the port and their plain versions.

K1 ``wilson_hop`` and K4 ``wilson_full`` (:mod:`.wilson_dslash`), K2
``cg_update`` and K3 ``cg_xpay`` (:mod:`.cg_fused`); :mod:`.build`
compiles ``csrc/*.cu``.  Each kernel has a float32 and a bf16 instance.
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


def pair_launches() -> dict[str, int]:
    """{kernel: n} since the last reset: the launches of the Wilson
    kernels' bf16 pair instances, a part of their ``<kernel>_bf16``
    launches (the rest ran the one-site instance)."""
    return {name + "_bf16": WRAPPERS[name].launches_bf16_pair
            for name in ("wilson_hop", "wilson_full")}


def counts() -> dict[str, dict[str, int]]:
    """{kernel: {"launches": n, "plain_calls": m}} since the last reset,
    with the bf16 instances as ``<kernel>_bf16``."""
    out = {}
    for name, fn in WRAPPERS.items():
        out[name] = {"launches": fn.launches, "plain_calls": fn.plain_calls}
        out[name + "_bf16"] = {"launches": fn.launches_bf16,
                               "plain_calls": fn.plain_calls_bf16}
    return out
