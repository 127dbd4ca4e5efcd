"""Generic file-based BO CLI — the equivalent of gryffin/src/gryffin/cli.py:
a config describes the parameter space; each invocation reads the
observations file (JSON list of {param: value, ..., obj: float}) and writes
the next recommendations. The port of the JAX package's ``cli/bo.py``; the
surrogate runs on ``--device`` (``cuda`` by default, which raises where CUDA
is absent; ``cpu`` on request).

    python -m event_representation_study_tpu_torch.cli.bo \
        --config space.json --observations obs.json --out recs.json [--device cpu]

space.json:
    {"parameters": [
        {"name": "w", "type": "categorical", "options": ["0", "1"],
         "descriptors": [[0.0], [1.0]]},
        {"name": "lr", "type": "continuous", "low": 1e-4, "high": 1e-1},
        {"name": "k", "type": "discrete", "low": 1, "high": 9}],
     "objective": "min", "batch": 2, "dynamic_descriptors": false}
"""
from __future__ import annotations

import argparse
import json
import pathlib


def build_space(cfg: dict):
    from ..search.mixed import CategoricalParamD, ContinuousParam, DiscreteParam

    params = []
    for p in cfg["parameters"]:
        t = p.get("type", "categorical")
        if t == "categorical":
            import numpy as np

            desc = p.get("descriptors")
            params.append(
                CategoricalParamD(
                    p["name"], list(p["options"]),
                    np.asarray(desc, float) if desc is not None else None,
                )
            )
        elif t == "continuous":
            params.append(ContinuousParam(p["name"], float(p["low"]), float(p["high"])))
        elif t == "discrete":
            params.append(DiscreteParam(p["name"], int(p["low"]), int(p["high"])))
        else:
            raise ValueError(f"unknown parameter type: {t}")
    return params


def main(args=None):
    ap = argparse.ArgumentParser("file-based BO loop (gryffin cli.py)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--observations", required=True,
                    help="JSON list of observation dicts (may not exist yet)")
    ap.add_argument("--out", required=True, help="recommendations JSON")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--bnn-train-steps", type=int, default=500)
    ap.add_argument("--bnn-draws", type=int, default=200)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(args)

    from ..search.mixed import MixedGryffin

    cfg = json.loads(pathlib.Path(args.config).read_text())
    obs_path = pathlib.Path(args.observations)
    observations = json.loads(obs_path.read_text()) if obs_path.exists() else []

    g = MixedGryffin(
        build_space(cfg),
        objective=cfg.get("objective", "min"),
        # gryffin's multi-objective mode: a hierarchy of
        # {name, goal, tolerance, absolute} dicts, Chimera-scalarized
        objectives=cfg.get("objectives"),
        random_seed=args.seed,
        bnn_train_steps=args.bnn_train_steps,
        bnn_draws=args.bnn_draws,
        dynamic_descriptors=bool(cfg.get("dynamic_descriptors", False)),
        device=args.device,
    )
    strategies = cfg.get("sampling_strategies")
    if strategies is None:
        b = int(cfg.get("batch", 2))
        strategies = [(-1) ** i for i in range(b)]
    recs = g.recommend(observations, sampling_strategies=strategies)
    pathlib.Path(args.out).write_text(json.dumps(recs, indent=1, default=float))
    print(json.dumps(recs, default=float))
    return recs


if __name__ == "__main__":
    main()
