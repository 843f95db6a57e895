"""Generated docs of the port.

Own copy of ``spark_rapids_tpu/plugin/docgen.py``. Reference analog:
RapidsConf.help (RapidsConf.scala:838) -> configs.md and TypeChecks.help
(TypeChecks.scala:1005) -> supported_ops.md, both generated from the
live registries so they cannot drift from the code. The port writes them
to ``docs/torch/`` (``docs/`` holds the reference's): ``configs.md`` from
the conf registry (``conf.py``; the rows are the reference's, and the
port's notes follow the table), ``supported_ops.md`` from the static type
matrices of ``plugin/typechecks.py``, the tables the planner tags with.
``python -m spark_rapids_tpu_torch.plugin.docgen`` regenerates them;
``--check`` exits 1 when a file is out of date.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..conf import _REGISTRY

#: where the port's generated docs live, relative to the repo root
DOCS_DIR = "docs/torch"


def _import_conf_modules() -> None:
    """Some conf entries register on first import of their module
    (``ml/columnar_rdd.py``, ``serve/scheduler.py``). The generated doc
    must not depend on what happens to be imported, so pull them all in
    first."""
    import importlib

    for mod in ("spark_rapids_tpu_torch.ml.columnar_rdd",
                "spark_rapids_tpu_torch.serve.scheduler"):
        importlib.import_module(mod)


def configs_md() -> str:
    _import_conf_modules()
    lines = [
        "# Configuration",
        "",
        "Generated from the conf registry (do not edit by hand; "
        "`python -m spark_rapids_tpu_torch.plugin.docgen`).",
        "",
        "| Key | Default | Description |",
        "|---|---|---|",
    ]
    for key in sorted(_REGISTRY):
        e = _REGISTRY[key]
        if e.internal:
            continue
        lines.append(f"| {e.key} | {e.default!r} | {e.doc} |")
    notes = [e for k, e in sorted(_REGISTRY.items())
             if e.port_note and not e.internal]
    if notes:
        lines += [
            "",
            "## On the port",
            "",
            "Where the PyTorch/CUDA port does the work a key controls "
            "another way than the description above says:",
            "",
            "| Key | On the port |",
            "|---|---|",
        ]
        lines += [f"| {e.key} | {e.port_note} |" for e in notes]
    return "\n".join(lines) + "\n"


def _param_rows(name: str, desc: str, ctx_label: str, cc) -> List[str]:
    """One table row per parameter plus the result row of one context.
    Cells are conf-INDEPENDENT by design: a conf-gated tag renders as PS
    with the gate named in Notes, never as a flipped cell."""
    from . import typechecks as TC

    rows = []
    entries: List[Tuple[str, object]] = [
        (pc.name, pc) for pc in cc.params
    ]
    if cc.repeat is not None:
        entries.append((f"{cc.repeat.name}...", cc.repeat))
    entries.append(("result", None))
    first = True
    for pname, pc in entries:
        sig = cc.output if pc is None else pc.sig
        cells = []
        notes = []
        for tag in TC.TYPE_TAGS:
            cells.append(sig.cell(tag))
            n = sig.cell_note(tag)
            if n:
                notes.append(f"{tag}: {n}")
        if pc is not None and pc.lit_required:
            notes.insert(0, "must be a literal")
        rows.append(
            "| " + " | ".join(
                [name if first else "", desc if first else "", ctx_label,
                 pname] + cells + ["; ".join(notes)]
            ) + " |"
        )
        first = False
    return rows


def supported_ops_md() -> str:
    """The supported-ops matrix doc: every expression rule's per-context,
    per-parameter type cells, the cast grid, and the exec rules — all
    read straight from typechecks.CHECKS / CAST_CHECKS."""
    from . import typechecks as TC
    from .overrides import EXEC_RULES, EXPRESSION_RULES

    head = " | ".join(TC.TYPE_TAGS)
    lines: List[str] = [
        "# Supported operators and expressions",
        "",
        "Generated ENTIRELY from the static type matrices in "
        "`plugin/typechecks.py` — the same tables the plan tagger uses — "
        "so this document cannot drift from behavior (reference: the "
        "TypeChecks-generated docs/supported_ops.md). Regenerate with "
        "`python -m spark_rapids_tpu_torch.plugin.docgen`; CI runs `--check`.",
        "",
        "Cells: `S` = supported; `PS` = partial support (see the Notes "
        "column: a conf gate, a literal-only parameter, or a documented "
        "restriction); blank = the plan falls back to CPU with a reason "
        "naming the rule, parameter, and type (read it from "
        "`TpuSession.explain()`, see docs/compatibility.md).",
        "",
        "## Expressions",
        "",
        f"| Expression | Description | Context | Param | {head} | Notes |",
        "|---" * (4 + len(TC.TYPE_TAGS) + 1) + "|",
    ]
    for cls in sorted(EXPRESSION_RULES, key=lambda c: EXPRESSION_RULES[c].name):
        r = EXPRESSION_RULES[cls]
        checks = TC.CHECKS.get(cls)
        if checks is None:
            lines.append(
                "| " + " | ".join(
                    [r.name, r.description, "-", "-"]
                    + [""] * len(TC.TYPE_TAGS)
                    + ["no matrix declared"]) + " |")
            continue
        # collapse contexts that share one ContextCheck (structural nodes)
        by_cc: Dict[int, List[str]] = {}
        cc_of: Dict[int, object] = {}
        for ctx in TC.CONTEXTS:
            cc = checks.contexts.get(ctx)
            if cc is None:
                continue
            by_cc.setdefault(id(cc), []).append(ctx)
            cc_of[id(cc)] = cc
        first = True
        for cid, ctxs in by_cc.items():
            label = "all" if len(ctxs) == len(checks.contexts) > 1 \
                else "/".join(ctxs)
            lines.extend(_param_rows(
                r.name if first else "", r.description if first else "",
                label, cc_of[cid]))
            first = False
    lines += [
        "",
        "## Casts",
        "",
        "The `Cast` from-type x to-type grid (`CastChecks`). `PS` cells "
        "are conf-gated or noted below.",
        "",
        f"| From \\ To | {head} |",
        "|---" * (1 + len(TC.TYPE_TAGS)) + "|",
    ]
    cast_notes: List[str] = []
    for frm in TC.TYPE_TAGS:
        sig = TC.CAST_CHECKS.matrix.get(frm, TC.none)
        cells = []
        for to in TC.TYPE_TAGS:
            cells.append(sig.cell(to))
            n = sig.cell_note(to)
            if n:
                cast_notes.append(f"* {frm} -> {to}: {n}")
        lines.append(f"| {frm} | " + " | ".join(cells) + " |")
    if cast_notes:
        lines += [""] + cast_notes
    lines += [
        "",
        "## Execs",
        "",
        "Exec rules tag their output schemas against the same engine type "
        "set (array/struct columns always fall back; decimal obeys "
        "spark.rapids.tpu.sql.decimalType.enabled and the DECIMAL64 cap).",
        "",
        "| Exec | Description |",
        "|---|---|",
    ]
    for cls in sorted(EXEC_RULES, key=lambda c: EXEC_RULES[c].name):
        r = EXEC_RULES[cls]
        lines.append(f"| {r.name} | {r.description} |")
    return "\n".join(lines) + "\n"


_DOCS = {
    "configs.md": configs_md,
    "supported_ops.md": supported_ops_md,
}


def write_docs(outdir: str = DOCS_DIR) -> None:
    import os

    os.makedirs(outdir, exist_ok=True)
    for fname, gen in _DOCS.items():
        with open(os.path.join(outdir, fname), "w") as f:
            f.write(gen())


def check_docs(outdir: str = DOCS_DIR) -> List[str]:
    """Names of generated docs that are out of sync with the registries
    (empty = clean). The CI `docgen --check` gate."""
    import os

    stale = []
    for fname, gen in _DOCS.items():
        path = os.path.join(outdir, fname)
        try:
            with open(path) as f:
                on_disk = f.read()
        except OSError:
            stale.append(fname)
            continue
        if on_disk != gen():
            stale.append(fname)
    return stale


def main(argv: List[str]) -> int:
    outdir = DOCS_DIR
    if "--outdir" in argv:
        outdir = argv[argv.index("--outdir") + 1]
    if "--check" in argv:
        stale = check_docs(outdir)
        if stale:
            print(
                "docs out of sync with the type matrix / conf registry: "
                + ", ".join(stale)
                + "\nregenerate with: python -m spark_rapids_tpu_torch.plugin.docgen",
                file=sys.stderr,
            )
            return 1
        print("generated docs are in sync")
        return 0
    write_docs(outdir)
    print(f"wrote {', '.join(_DOCS)} to {outdir}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
