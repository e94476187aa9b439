"""Trace replay: render a saved JSONL trace back into a timeline.

``python -m repro_torch.obs.replay trace.jsonl`` prints

* a per-chip **timeline table** — every span/event in seq order, with its
  step interval, chip column, and the load-bearing attrs, so a fleet
  run's interleaved admission/decode/maintenance history reads like the
  schedule it was;
* a **latency summary** rebuilt purely from the trace events
  (queue-wait from ``admit``, TTFT from ``first_token``, request sizes
  from ``finish``) — no metrics snapshot needed, the trace is
  self-describing.

Wall-clock fields, when present (``--trace-wall-clock`` runs), are shown
in an extra column; traces without them render identically across reruns
because the entries ARE identical (the step clock is the primary — see
``repro_torch.obs.trace``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import read_jsonl

# attrs rendered in their own columns rather than the attr blob
_STRUCTURAL = ("kind", "seq", "step", "end_step", "name", "type", "chip",
               "wall_s", "wall_dur_s")


def _attr_blob(e: dict) -> str:
    parts = [f"{k}={e[k]}" for k in e if k not in _STRUCTURAL]
    return " ".join(parts)


def render_timeline(entries: List[dict],
                    chip: Optional[str] = None) -> List[str]:
    """The per-chip timeline table, one line per trace entry."""
    if chip is not None:
        entries = [e for e in entries if e.get("chip") == chip]
    has_wall = any("wall_dur_s" in e or "wall_s" in e for e in entries)
    lines = [(f"{'seq':>5} {'step':>6} {'chip':<8} {'what':<22} "
              + (f"{'wall':>10} " if has_wall else "") + "attrs")]
    for e in entries:
        step = e.get("step", 0)
        span = f"{step}..{e['end_step']}" if "end_step" in e \
            and e["end_step"] != step else str(step)
        what = e.get("name") if e.get("kind") == "span" else \
            f"[{e.get('type', '?')}]"
        wall = ""
        if has_wall:
            dur = e.get("wall_dur_s")
            wall = f"{dur * 1e3:>9.2f}ms " if dur is not None \
                else f"{'':>10} "
        lines.append(f"{e.get('seq', 0):>5} {span:>6} "
                     f"{e.get('chip', '-'):<8} {what:<22} "
                     f"{wall}{_attr_blob(e)}")
    return lines


def latency_summary(entries: List[dict]) -> Dict[str, dict]:
    """Latency distributions rebuilt from the trace's own events."""
    hists = {"queue_wait_steps": Histogram("queue_wait_steps"),
             "ttft_steps": Histogram("ttft_steps"),
             "tokens_per_request": Histogram("tokens_per_request")}
    for e in entries:
        if e.get("kind") != "event":
            continue
        if e.get("type") == "admit" and "queue_wait_steps" in e:
            hists["queue_wait_steps"].record(e["queue_wait_steps"])
        elif e.get("type") == "first_token" and "ttft_steps" in e:
            hists["ttft_steps"].record(e["ttft_steps"])
        elif e.get("type") == "finish" and "n_tokens" in e:
            hists["tokens_per_request"].record(e["n_tokens"])
    return {k: h.summary() for k, h in hists.items()}


def chips_in(entries: List[dict]) -> List[str]:
    return sorted({e["chip"] for e in entries if "chip" in e})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.replay",
        description="Render a repro.obs JSONL trace (from `launch.serve "
                    "--trace`) into a per-chip timeline + latency summary.")
    ap.add_argument("trace", help="path to the JSONL trace")
    ap.add_argument("--chip", default="",
                    help="show only this chip's timeline rows")
    ap.add_argument("--last", type=int, default=0,
                    help="show only the last N timeline rows (0 = all)")
    args = ap.parse_args(argv)

    entries = read_jsonl(args.trace)
    chips = chips_in(entries)
    n_spans = sum(1 for e in entries if e.get("kind") == "span")
    print(f"[replay] {args.trace}: {len(entries)} entries "
          f"({n_spans} spans, {len(entries) - n_spans} events)"
          + (f", chips: {', '.join(chips)}" if chips else ""))
    lines = render_timeline(entries, chip=args.chip or None)
    header, rows = lines[0], lines[1:]
    if args.last and len(rows) > args.last:
        print(f"[replay] ... {len(rows) - args.last} earlier rows elided")
        rows = rows[-args.last:]
    print(header)
    for line in rows:
        print(line)
    print("[replay] latency summary (from trace events):")
    for name, s in latency_summary(entries).items():
        print(f"  {name:<20} n={s['count']:<6} p50 {s['p50']:<10g} "
              f"p95 {s['p95']:<10g} p99 {s['p99']:<10g} "
              f"max {s['max']:g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
