"""The program's FLOP per second in the device stretch as a share of the
card's dense TF32 peak (%; the bf16 peak for bf16 serving). The FLOP are
counted by FlopCounterMode over the plain reference at the cell's shapes:
per served call, by the call's key, or per training step (the forward,
the discriminator's update with its gradient penalty, the generator's
backward: the reference's first step); the time is the stretch's wall
time in the device trace."""

from counts import PEAKS


def read(record):
    w, flop, tr = record["window"], record["flop"], record["trace"]
    if not flop or tr is None or not tr.n_iter:
        return None
    if isinstance(flop, dict):
        if not w.get("keys"):
            return None
        first = record["workload"]["profile"][0]
        total = sum(flop[k] for k in w["keys"][first:first + tr.n_iter])
    else:
        if not w.get("steps"):
            return None
        total = flop * tr.n_iter
    peak = PEAKS["bf16_flop_per_s" if record["config"].get("serve_dtype") == "bfloat16"
                 else "tf32_flop_per_s"]
    return total / tr.window_s / peak * 100.0
