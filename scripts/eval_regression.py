#!/usr/bin/env python
"""Eval score-regression harness: run a fixed task subset on synthetic
docs across git revisions and diff per-task scores.

The analogue of the reference's `/root/reference/eval/tools/regression.py`
(itself from lm-evaluation-harness): that tool checks out branches and
diffs published-task scores.  With 131 self-implemented task families
(eval/tasks{,_ext}.py) this rebuild has MORE scoring surface needing the
guard, and it must run OFFLINE — so instead of HF datasets it generates
deterministic synthetic jsonl docs per task (schema-exact for each task's
score_doc), runs the tiny random-init model (seed-pinned, greedy), and
compares metric-for-metric.  With identical code the scores are
bit-identical; any diff is a behavior change in prompting, generation,
filtering, or scoring.

Usage:
  python scripts/eval_regression.py --revs HEAD~1            # vs worktree
  python scripts/eval_regression.py --revs main,my-branch    # two revs
  python scripts/eval_regression.py --tasks chartqa,pope --limit 4

Exit status 1 if any |score diff| > --threshold (default 1e-9: exact).
Revisions are materialized with `git worktree add --detach` (the current
working tree is never touched, unlike the reference's `git checkout`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# default subset: one task per scoring family — relaxed-acc VQA, strict
# string compare + ratio aggregate, CIDEr caption, regex-filtered math,
# category-paired MME
DEFAULT_TASKS = "chartqa,pope,coco2017_cap_val_lite,gsm8k,mme"


def make_fixtures(workdir: str, tasks: list[str], n: int) -> dict:
    """Write deterministic synthetic docs per task; returns
    {task: jsonl_path}.  Doc fields match each task's score_doc schema
    (eval/tasks.py) so scoring exercises the real code paths."""
    import numpy as np
    from PIL import Image

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0)
    img_names = []
    for i in range(n):
        p = os.path.join(workdir, f"img{i}.png")
        if not os.path.exists(p):
            Image.fromarray(
                rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
            ).save(p)
        img_names.append(f"img{i}.png")

    def docs_for(task: str):
        for i in range(n):
            img = img_names[i]
            if task == "pope":
                yield {"text": f"Is there a dog in object {i}?",
                       "target": "yes" if i % 2 else "no", "image": img}
            elif task == "gsm8k":
                yield {"text": f"Tom has {i} apples and buys {i + 2} "
                               f"more. How many apples does Tom have?",
                       "target": f"reasoning...\n#### {2 * i + 2}"}
            elif task == "coco2017_cap_val_lite":
                yield {"text": "placeholder",  # doc_mapper overwrites
                       "target": [f"a photo of object {i}",
                                  f"object {i} on a table"],
                       "image": img}
            elif task == "mme":
                # MME pairs two rows per question_id for the acc+ metric
                yield {"text": f"Is this image number {i}? Answer yes "
                               "or no.", "target": "yes" if i % 2 else "no",
                       "question_id": str(i // 2),
                       "category": "existence", "image": img}
            else:  # generic VQA schema (chartqa and most others)
                yield {"text": f"What is the value of bar {i}?",
                       "target": str(10 * i + 2), "image": img}

    paths = {}
    for t in tasks:
        p = os.path.join(workdir, f"{t}.jsonl")
        with open(p, "w") as f:
            for d in docs_for(t):
                f.write(json.dumps(d) + "\n")
        paths[t] = p
    return paths


def calibrate_fixtures(fixtures: dict, limit: int, workdir: str):
    """Plant worktree predictions as targets on even-indexed docs so the
    scores are NONZERO: with every target unreachable by the random tiny
    model, every metric is 0.0 and a broken scorer would diff as 'no
    change'.  After this pass, matches AND mismatches flow through each
    task's parse/filter/score path, and the planted scores move if
    prompting, generation, filtering, or scoring changes."""
    cal = run_eval(REPO, list(fixtures), fixtures, limit,
                   os.path.join(workdir, "calibration.json"),
                   log_samples=True)
    for task, path in fixtures.items():
        preds = {s["id"]: s["prediction"]
                 for s in cal.get(task, {}).get("samples", [])}
        docs = [json.loads(l) for l in open(path)]
        for i, d in enumerate(docs):
            p = preds.get(d.get("id", i), preds.get(i))
            if p is None or i % 2:
                continue
            if task == "gsm8k":
                d["target"] = f"planted\n#### {p}"
            elif task == "coco2017_cap_val_lite":
                d["target"] = [p, d["target"][0] if
                               isinstance(d["target"], list) else "x"]
            else:  # strict / relaxed string compare families
                d["target"] = p
        with open(path, "w") as f:
            for d in docs:
                f.write(json.dumps(d) + "\n")


def run_eval(tree: str, tasks: list[str], data_paths: dict, limit: int,
             out_path: str, log_samples: bool = False) -> dict:
    """Run the eval CLI from source tree `tree` (tiny model, CPU)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=tree)
    cmd = [
        sys.executable, "-m", "lavida_mod.eval", "--tiny",
        "--tasks", ",".join(tasks),
        "--data-path", ",".join(f"{t}={p}" for t, p in data_paths.items()),
        "--limit", str(limit), "--output", out_path,
    ] + (["--log-samples"] if log_samples else [])
    r = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                       text=True)
    if r.returncode != 0:
        print(r.stdout[-2000:], file=sys.stderr)
        print(r.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"eval failed in {tree}")
    with open(out_path) as f:
        return json.load(f)


def scores_of(results: dict) -> dict:
    """Flatten {task: {results: {...}}} to {task/metric: float}."""
    flat = {}
    for task, r in results.items():
        for k, v in r.get("results", {}).items():
            # timings are not scores (wall_s, avg_latency_s, ...)
            if isinstance(v, (int, float)) and k != "n_docs" \
                    and not k.endswith("_s"):
                flat[f"{task}/{k}"] = float(v)
    return flat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--revs", default="HEAD",
                    help="comma-separated git revs to compare against the "
                         "current working tree")
    ap.add_argument("--tasks", default=DEFAULT_TASKS)
    ap.add_argument("--limit", type=int, default=6)
    ap.add_argument("--threshold", type=float, default=1e-9)
    ap.add_argument("--workdir", default="/tmp/eval_regression")
    args = ap.parse_args()

    tasks = args.tasks.split(",")
    fixtures = make_fixtures(args.workdir, tasks, args.limit)
    print("[regression] calibrating fixtures (planting worktree "
          "predictions as even-doc targets)")
    calibrate_fixtures(fixtures, args.limit, args.workdir)

    runs = {}
    print(f"[regression] worktree: {REPO}")
    runs["worktree"] = scores_of(run_eval(
        REPO, tasks, fixtures, args.limit,
        os.path.join(args.workdir, "results_worktree.json")))

    for rev in args.revs.split(","):
        rev = rev.strip()
        tree = os.path.join(args.workdir, "rev_" + rev.replace("/", "_"))
        subprocess.run(["git", "worktree", "remove", "--force", tree],
                       cwd=REPO, capture_output=True)
        r = subprocess.run(
            ["git", "worktree", "add", "--detach", tree, rev],
            cwd=REPO, capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"git worktree add {rev} failed: {r.stderr}")
        try:
            print(f"[regression] rev {rev}: {tree}")
            runs[rev] = scores_of(run_eval(
                tree, tasks, fixtures, args.limit,
                os.path.join(args.workdir, f"results_{rev.replace('/', '_')}.json")))
        finally:
            subprocess.run(["git", "worktree", "remove", "--force", tree],
                           cwd=REPO, capture_output=True)

    # markdown diff table (reference format_diff: bold regressions)
    keys = sorted({k for s in runs.values() for k in s})
    names = list(runs)
    print("\n| metric | " + " | ".join(names) + " | max diff |")
    print("|---" * (len(names) + 2) + "|")
    worst = 0.0
    for k in keys:
        vals = [runs[n].get(k) for n in names]
        nums = [v for v in vals if v is not None]
        diff = (max(nums) - min(nums)) if len(nums) > 1 else float("nan")
        worst = max(worst, diff if diff == diff else worst)
        cells = [f"{v:.6f}" if v is not None else "—" for v in vals]
        flag = f"**{diff:.2e}**" if diff > args.threshold else f"{diff:.1e}"
        print(f"| {k} | " + " | ".join(cells) + f" | {flag} |")

    if worst > args.threshold:
        print(f"\n[regression] FAIL: max diff {worst:.3e} > "
              f"{args.threshold:.1e}")
        raise SystemExit(1)
    print(f"\n[regression] OK: max diff {worst:.3e} <= "
          f"{args.threshold:.1e}")


if __name__ == "__main__":
    main()
