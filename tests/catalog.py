"""The whole on-device effect catalog as a training bank and an effects
YAML, standard library only (it imports neither JAX nor either package, so
``chip_smoke.py`` uses it on the card too)."""

import json

# the 20 on-device branches, with scalar parameters, so the scheduler's
# (name, params) choices match the bank's specs
CATALOG20 = [
    ("identity", {}), ("highpass_filter", {"cutoff_freq": 500}),
    ("highpass_filter", {"cutoff_freq": 3500}), ("lowpass_filter", {"cutoff_freq": 1000}),
    ("lowpass_filter", {"cutoff_freq": 2000}),
    ("bandpass_filter", {"cutoff_freq_low": 300, "cutoff_freq_high": 4000}),
    ("speed", {"speed": 0.8}), ("resample", {"new_sample_rate": 32000}),
    ("random_noise", {"noise_std": 0.001}), ("random_equalization", {}), ("echo", {}),
    ("white_noise", {"noise_std": 0.01}), ("pink_noise", {"noise_std": 0.01}),
    ("amplitude_scaling", {"scale": 0.7}), ("quantization", {"bit_depth": 8}),
    ("sample_suppression", {"suppression_percentage": 0.1}),
    ("shush", {"fraction": 0.001}), ("median_filter", {"kernel_size": 4}),
    ("smooth", {"window_size": 5}), ("codec_proxy", {}),
]


def catalog_yaml() -> str:
    """An effects YAML (conf/effects_config.yml schema) whose
    ``effect_param_grid``, ``train_effects`` and ``eval_effects`` list
    CATALOG20 (JSON flow values are YAML)."""
    grid = {}
    for name, params in CATALOG20:
        entry = grid.setdefault(name, {})
        for k, v in params.items():
            entry.setdefault(k, {"choices": []})["choices"].append(v)
    specs = "".join(f"  - name: {n}\n    params: {json.dumps(p)}\n" for n, p in CATALOG20)
    return ("effect_param_grid: " + json.dumps(grid) + "\n"
            + "train_effects:\n" + specs + "eval_effects:\n" + specs)
