"""Benchmark evaluation entry point, MMAU / SAKURA (port of
``desta25_audio_tpu/cli/evaluate.py``; replaces the CLI surface of the
reference's examples/evaluation/{mmau_eval.py,sakura_eval.py}):

    python -m desta25_audio_tpu_torch.cli.evaluate --benchmark mmau \\
        --model /path/to/ckpt --data items.jsonl --out report.json \\
        [--judge-model /path/to/judge_ckpt] [--device cuda|cpu]

``--data`` is a local JSON/JSONL file of benchmark items (audio paths
resolved relative to --data-root; URLs are refused, as the port's dataset
refuses them).  The judge, when given, is a text-only DeSTA checkpoint
(Qwen3 backbone, the reference's judge choice).  The frozen towers come
from ``$DESTA_TPU_WEIGHTS`` (``from_pretrained``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..utils.misc import resolve_filepath


def load_items(path: str, data_root: str = ""):
    path = resolve_filepath(path)
    items = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                if line.strip():
                    items.append(json.loads(line))
    else:
        with open(path) as f:
            data = json.load(f)
        items = data if isinstance(data, list) else data["items"]
    for it in items:
        a = it.get("audio")
        if isinstance(a, str) and data_root and not os.path.isabs(a):
            it["audio"] = os.path.join(data_root, a)
    return items


def parse_overrides(pairs):
    """``["encoder_quant=none", "llm_quant=int8"]`` -> config-override
    dict; values parse as JSON (numbers/bools/null) falling back to str."""
    overrides = {}
    for ov in pairs:
        key, sep, val = ov.partition("=")
        if not sep:
            raise SystemExit(f"--override expects KEY=VALUE, got {ov!r}")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    return overrides


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--benchmark", choices=["mmau", "sakura"],
                        required=True)
    parser.add_argument("--model", required=True,
                        help="DeSTA checkpoint dir (from save_pretrained)")
    parser.add_argument("--data", required=True)
    parser.add_argument("--data-root", default="")
    parser.add_argument("--out", default=None)
    parser.add_argument("--judge-model", default=None)
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--limit", type=int, default=-1)
    parser.add_argument("--override", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="DeSTA25Config field override applied after "
                             "the checkpoint's config.json loads, e.g. "
                             "--override encoder_quant=none (repeatable; "
                             "values parsed as JSON, falling back to str)")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the models (default cuda)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    overrides = parse_overrides(args.override)

    from ..models.desta import DeSTA25AudioModel
    model = DeSTA25AudioModel.from_pretrained(
        args.model, args.device, config_overrides=overrides or None)

    judge = None
    if args.judge_model:
        from ..eval.judge import make_desta_judge
        judge_model = DeSTA25AudioModel.from_pretrained(args.judge_model,
                                                        args.device)
        judge = make_desta_judge(judge_model)

    items = load_items(args.data, args.data_root)
    if args.limit > 0:
        items = items[:args.limit]

    if args.benchmark == "mmau":
        from ..eval.mmau import evaluate_mmau
        report = evaluate_mmau(model, items, judge=judge,
                               out_path=args.out,
                               max_new_tokens=args.max_new_tokens)
    else:
        from ..eval.sakura import evaluate_sakura
        if judge is None:
            raise SystemExit("sakura requires --judge-model")
        report = evaluate_sakura(model, items, judge, out_path=args.out,
                                 max_new_tokens=args.max_new_tokens)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
