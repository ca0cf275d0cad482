"""Share of AudioSeal's residual block calls that ran the fused block
kernel (%): the port's ``seanet.resblock`` spans in the ``api.embed_batch``
and ``api.detect_batch`` roots of the device stretch that hold a
``resblock.fused`` span as a child, over all of them. None where the kept
roots hold no ``seanet.resblock`` span, or no ``resblock.fused`` span at
all (a port without the kernel)."""

from pbcore.program_spans import SERVE, kept_roots

OUTER, INNER = "seanet.resblock", "resblock.fused"


def read(record):
    outer, held, inner = 0, 0, 0
    for name in SERVE:
        for tree in kept_roots(record, name):
            ids = {s["id"] for s in tree if s["name"] == OUTER}
            parents = {s["parent"] for s in tree if s["name"] == INNER}
            outer += len(ids)
            held += len(ids & parents)
            inner += len(parents)
    if not outer or not inner:
        return None
    return held / outer * 100.0
