"""Per-component profile of the radius step under the R-rep protocol: the
port's twin of ``tools/profile_stages2.py``.

The components of :mod:`.profile_stages` (range lookup, chunk
descriptors, fetch + score, strips + merge by ``table_topk_packed`` and by
the production path's ``table_topk_chunkmin_packed``) at stage-1 and
stage-2 shapes, each timed as ``(t_R - t_1) / (R - 1)``: R calls back to
back with one device sync at the end, against one
(``tools/_profile.rep_ms``). A difference below the clock's noise can come
out negative and is printed as measured.

The JAX tool's "unified merge" rows time ``merge_topk_dedup_packed``, one
of the uint32 selections the port replaced by ascending int64 selections
(ROADMAP.md, Not ported): they are left out, and the JSON line names them
(``left_out``).

Usage: python -m verticut_tpu_torch.tools.profile_stages2 [--n 1000000]
[--q 8192] [--r 8] [--device cpu]
"""

from __future__ import annotations

from verticut_tpu_torch.tools import _profile
from verticut_tpu_torch.tools.profile_stages import parse, run

LEFT_OUT = {
    f"s{s}[...] unified merge k={k}":
        "merge_topk_dedup_packed is a uint32 selection of the reference "
        "that the port replaced by ascending int64 selections"
    for s in (1, 2) for k in (10, 100)}


def stage2_tag(stage: int, nq: int, h: int, cap: int, chb: int) -> str:
    return f"s{stage}[{nq}x{h}]"


def main(argv=None):
    args = parse(argv, __doc__, r_flag=True)
    return run(args, "profile_stages2",
               lambda fn, dev: _profile.rep_ms(fn, dev, args.r),
               tag=stage2_tag, chunkmin=True, left_out=LEFT_OUT)


if __name__ == "__main__":
    main()
