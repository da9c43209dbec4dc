"""Embedder model, its routed experts (``models/moe.py``'s ``expert_mlp``):
the routed-expert FLOPs of the tokens embedded by the window's close (the
``routed_expert_flops_per_token`` of the configuration's reference module,
from the shapes) over the device seconds the trace gives the grouped GEMM
kernel of ``torch._grouped_mm``, times the dense bf16 peak, in percent.
The kernel's seconds hold the work of a micro-batch still in flight at the
close, whose tokens are not counted, so this reads low rather than high.
None where the trace holds no such kernel (a program or a configuration
without it)."""

from bench.lib import spec, yardstick

# The name the device trace gives the grouped GEMM (CUTLASS's sm90 kernel
# over a ``GroupProblemShape``; one instantiation for gate, up and down on
# the H100 with torch 2.11), as cut to its first 120 characters.
KERNELS = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel13GemmUniversal"
           "INS5_17GroupProblem",)


def read(rec: dict) -> float | None:
    dev = rec["device"]
    if dev is None:
        return None
    seconds = sum(s for name, s in dev["device_ops"] if name.startswith(KERNELS))
    end = rec["t0"] + rec["seconds"]
    done = [e for e in rec["embeds"] if e["t1"] <= end]
    per_token = getattr(spec.reference(rec["config"]["reference"]), "routed_expert_flops_per_token", None)
    if seconds <= 0 or not done or per_token is None:
        return None
    flops = sum(e["tokens"] for e in done) * per_token(rec["config"]["model"])
    return 100.0 * flops / (seconds * yardstick.PEAK_BF16_FLOPS)
