"""The program's device kernels by the names a trace gives them: the
layers' per-layer metrics sum the device time of these."""

#: K1, the AR loop (csrc/ar_persistent.cu)
K1 = ("ar_persistent_kernel",)
#: K2 and K3, the layer stack (csrc/wn_wgmma.cuh's product core, and
#: csrc/layer_stack_bwd.cu's reductions); K2 alone in a decode cell
STACK = ("wg_kernel", "reduce_chunks_kernel", "colsum_kernel")
#: The collectives' kernels (NCCL)
COLLECTIVE = ("nccl",)


def matcher(patterns):
    def match(name: str) -> bool:
        low = name.lower()
        return any(p.lower() in low for p in patterns)
    return match
