"""Share of the window's attention FLOPs (QK^T and PV) that the program's
dispatch sent to the flash_attention kernel rather than the plain path, in
%: its route counters (``bbdm_tpu_torch.ops.attention.ROUTES``, a replayed
step counted as its capture) read before and after the window. A program
without the counters leaves it out."""


def read(obs):
    routes = obs.get("attention_routes")
    if not routes:
        return None
    total = routes["kernel"][1] + routes["plain"][1]
    return 100.0 * routes["kernel"][1] / total if total else None
