"""Offline results aggregation (ref: result_convert.py:19-160), without pandas.

Counterpart of tools/aggregate_results.py, on ``csv`` and numpy. Collects
the per-run group-retransformed metric tables (``*_trans.csv``) of an
outputs tree and produces:
  * a per-model x horizon summary (mean over runs);
  * mean +/- std over seeds (the sample std, ddof 1; NaN for one run)
    when several runs of the same model exist;
  * a %-improvement comparison against a chosen reference model.

Tables are column dicts (``{name: np.ndarray}``, in column order), as
``data/atomic.read_csv`` returns them; a summary has pandas' columns in
pandas' order: ``Model_name``, ``MAE_mean``, ``MAE_std``, ... ``MAPE_std``,
``horizon``, then the ``*_vs_ref_pct`` columns. As pandas does, the means
and stds skip NaN entries, and a written NaN is an empty cell.

Usage:
    python -m multistgraph_tpu_torch.tools.aggregate_results ./outputs \\
        --horizons 3 6 12 24 --reference MultiATGCN --out summary.csv
"""

import argparse
import csv
import glob
import os
import sys
from typing import Dict, List, Sequence

import numpy as np

from multistgraph_tpu_torch.data.atomic import read_csv

Table = Dict[str, np.ndarray]

METRICS = ("MAE", "MSE", "RMSE", "R2", "EVAR", "MAPE")
IMPROVED = ("MAE_mean", "RMSE_mean", "MAPE_mean")


def read_table(path: str) -> Table:
    """A CSV as a column dict, its unnamed index column (pandas' ``to_csv``
    with the index) dropped."""
    table = read_csv(path)
    table.pop("", None)
    return table


def write_table(path: str, table: Table, index: bool = False) -> None:
    """A column dict as a CSV, NaN as an empty cell; with `index`, a leading
    unnamed column of row numbers, as pandas' ``to_csv`` writes it."""
    columns = list(table)
    rows = len(next(iter(table.values()))) if table else 0

    def cell(v):
        if isinstance(v, (float, np.floating)):
            return "" if np.isnan(v) else repr(float(v))
        return v.item() if isinstance(v, np.generic) else v

    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(([""] if index else []) + columns)
        for i in range(rows):
            writer.writerow(([i] if index else []) + [cell(table[c][i]) for c in columns])


def concat(tables: Sequence[Table]) -> Table:
    """Tables stacked by rows; a column missing from a table is NaN there,
    and the columns keep the order in which they first appear."""
    columns: List[str] = []
    for t in tables:
        columns += [c for c in t if c not in columns]
    sizes = [len(next(iter(t.values()))) for t in tables]
    return {c: np.concatenate([t[c] if c in t else np.full(n, np.nan) for t, n in zip(tables, sizes)])
            for c in columns}


def take(table: Table, rows) -> Table:
    return {c: v[rows] for c, v in table.items()}


def collect_trans_tables(output_root: str) -> Table:
    """Every ``<run>/evaluate_cache/*_trans.csv`` under `output_root`, with
    the columns ``run`` (the run's directory name) and ``source``."""
    tables = []
    for path in glob.glob(os.path.join(output_root, "*", "evaluate_cache", "*_trans.csv")):
        t = read_table(path)
        n = len(t["Model_name"])
        t["run"] = np.full(n, os.path.basename(os.path.dirname(os.path.dirname(path))), dtype=object)
        t["source"] = np.full(n, path, dtype=object)
        tables.append(t)
    if not tables:
        raise SystemExit("no *_trans.csv found under {}".format(output_root))
    table = concat(tables)
    for m in METRICS:
        table[m] = table[m].astype(np.float64)
    table["Model_name"] = table["Model_name"].astype(str)
    return table


def _mean_std(values: np.ndarray):
    values = values[~np.isnan(values)]
    mean = values.mean() if len(values) else np.nan
    return mean, (values.std(ddof=1) if len(values) > 1 else np.nan)


def summarize(table: Table, horizons) -> Table:
    """Per horizon h (the first h steps: ``index < h``), each model's
    metrics averaged per run, then their mean and std over runs; the
    models in sorted order, the horizons in the order given."""
    columns = ["Model_name"] + ["{}_{}".format(m, s) for m in METRICS for s in ("mean", "std")] + ["horizon"]
    out = {c: [] for c in columns}
    names, runs = np.asarray(table["Model_name"]), np.asarray(table["run"])
    for h in horizons:
        keep = np.asarray(table["index"]) < h
        for name in sorted(set(names[keep])):
            of_model = keep & (names == name)
            per_run = {m: [] for m in METRICS}
            for run in sorted(set(runs[of_model])):
                rows = of_model & (runs == run)
                for m in METRICS:
                    per_run[m].append(_mean_std(table[m][rows])[0])
            out["Model_name"].append(name)
            for m in METRICS:
                mean, std = _mean_std(np.asarray(per_run[m], np.float64))
                out[m + "_mean"].append(mean)
                out[m + "_std"].append(std)
            out["horizon"].append(h)
    return {c: np.asarray(v, dtype=object if c == "Model_name" else None) for c, v in out.items()}


def add_improvement(summary: Table, reference: str) -> Table:
    """The rows grouped by horizon (ascending), and per horizon with a
    `reference` row the % gap of each model's MAE, RMSE and MAPE means to
    the reference's: ``MAE_vs_ref_pct``, ... (NaN at horizons without it;
    no such column when no horizon has it)."""
    horizons = np.asarray(summary["horizon"])
    order = np.concatenate([np.flatnonzero(horizons == h) for h in sorted(set(horizons.tolist()))]
                           or [np.zeros(0, np.int64)])
    out = take(summary, order)
    names, horizons = np.asarray(out["Model_name"]), np.asarray(out["horizon"])
    pct = {m.replace("_mean", "_vs_ref_pct"): np.full(len(order), np.nan) for m in IMPROVED}
    found = False
    for h in sorted(set(horizons.tolist())):
        rows = horizons == h
        ref = np.flatnonzero(rows & (names == reference))
        if not len(ref):
            continue
        found = True
        for m in IMPROVED:
            ref_val = float(out[m][ref[0]])
            pct[m.replace("_mean", "_vs_ref_pct")][rows] = 100.0 * (out[m][rows].astype(np.float64) - ref_val) / ref_val
    if found:
        out.update(pct)
    return out


def format_table(table: Table) -> str:
    """The table as aligned text, one row a line."""
    columns = list(table)

    def text(v):
        if isinstance(v, (float, np.floating)):
            return "NaN" if np.isnan(v) else "{:.6g}".format(float(v))
        return str(v)

    cells = [[text(v) for v in table[c]] for c in columns]
    widths = [max([len(c)] + [len(x) for x in col]) for c, col in zip(columns, cells)]
    lines = [" ".join(c.rjust(w) for c, w in zip(columns, widths))]
    for i in range(len(cells[0]) if cells else 0):
        lines.append(" ".join(col[i].rjust(w) for col, w in zip(cells, widths)))
    return "\n".join(lines)


def main(argv=None) -> Table:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("output_root")
    parser.add_argument("--horizons", type=int, nargs="+", default=[3, 6, 12, 24])
    parser.add_argument("--reference", type=str, default=None)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    summary = summarize(collect_trans_tables(args.output_root), args.horizons)
    if args.reference:
        summary = add_improvement(summary, args.reference)
    if args.out:
        write_table(args.out, summary)
        print("wrote {}".format(args.out), file=sys.stderr)
    print(format_table(summary))
    return summary


if __name__ == "__main__":
    main()
