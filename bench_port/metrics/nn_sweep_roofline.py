"""``nn_sweep_roofline``: 100 x the NN sweeps' least time on one
H100 (``roofline.nn_bound_s``: 4 FP32 FMA-class operations per valid
source x valid target row, at 33.5 T FMA/s; each input read once and
each output written once at 3.35 TB/s; the operations bind at these
sizes) over the device time of the kernels named ``nn_sweep_pass*`` in
the traced window. The sweeps are counted from the inputs and the
entry's reported ICP iterations (``Entry.nn_sweeps``), so the count is
the algorithm's whatever implements it. Nothing is read where the entry
does not report them, or no such kernel ran. Layer: the kernels
(``csrc/nn_sweep.cu`` through ``ops/nn.py``)."""

from bench_port.roofline import nn_bound_s

KERNEL = "nn_sweep_pass"


def read(ctx: dict):
    work = ctx["nn_work"]
    kernel_s = sum(v for k, v in ctx["time_by_name"].items() if KERNEL in k)
    if not work or kernel_s <= 0:
        return None
    return 100.0 * sum(nn_bound_s(s, t)[0] for s, t in work) / kernel_s
