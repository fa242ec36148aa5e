"""``nn_source_use_pct``: 100 x the valid sources of the traced window's
NN sweeps (``Entry.nn_sweeps``, counted from the inputs) over the source
rows the program handed its NN sweeps (its counter ``nn.source_rows``,
summed over the window's calls). Below 100 the kernel sweeps dead slots.
Nothing is read from a program without the tracer or where the entry
does not report its sweeps. Layer: the kernels."""

from bench_port import program


def read(ctx: dict):
    work, recorded = ctx["nn_work"], program.spans()
    if not work or recorded is None:
        return None
    rows = program.counted(recorded, "nn.source_rows")
    return 100.0 * sum(s for s, _ in work) / rows if rows else None
