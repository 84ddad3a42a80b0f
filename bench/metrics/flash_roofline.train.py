"""The flash kernels' share of their roofline in the split step: each
launch's least time (the larger of its operations over the bf16 peak and
its bytes over the HBM bandwidth, ``bench/arith.py``: causal visible
pairs) summed over the launches the port's counters saw in the traced
window, over the flash kernels' device time there (%)."""
from bench import arith

FLASH_GROUPS = ("flash_fwd_tensor_cores", "flash_bwd_tensor_cores", "flash")


def read(ctx):
    if ctx["kind"] != "train" or not ctx["peaks"]:
        return None
    device_s = sum(ctx["trace"]["groups_s"].get(g, 0.0) for g in FLASH_GROUPS)
    launches = ctx["counters"]
    if device_s <= 0 or not any(launches.values()):
        return None
    sh, pk = ctx["work"]["flash_shape"], ctx["peaks"]
    least = 0.0
    for stage, n in launches.items():
        ops = arith.flash_stage_flops(stage, sh["batch"], sh["heads"],
                                      sh["seq"], sh["hd"])
        nbytes = arith.flash_stage_bytes(stage, sh["batch"], sh["heads"],
                                         sh["kv_heads"], sh["seq"], sh["hd"])
        least += n * max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes"])
    return 100.0 * least / device_s
