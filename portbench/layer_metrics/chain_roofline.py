"""The resblock-chain kernels' share of their roofline per embed+detect
call (%): the least time the card could take for the chains (each chain's
larger of its FLOP over the TF32 peak and its bytes over the memory
bandwidth, from its shape by ``counts.chain_cost``: the algorithm's work,
counted once; summed over the call's chains), over the device time of the
kernels named ``resblock_chain*`` in the device stretch."""

from counts import chains_bound_s


def read(record):
    tr = record["trace"]
    if tr is None or not tr.n_iter:
        return None
    busy = tr.kernel_s("resblock_chain") / tr.n_iter
    if busy <= 0:
        return None
    cfg, wl = record["config"], record["workload"]
    t = int(round(wl["clip_s"] * cfg["model"]["Generator"]["sample_rate"]))
    bound = chains_bound_s(cfg["model"], wl["batch"], t, cfg.get("serve_dtype") == "bfloat16")
    return bound / busy * 100.0
