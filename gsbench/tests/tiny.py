"""A cell cut to a size the CPU tests hold: 3,000 Gaussians in 4,096
slots, four 96x64 views, one warm-up step, two traced steps."""

TINY = {"config": {"tpu": {"capacity": 4096}, "bench": {
    "population": {"count": 3000, "capacity": 4096},
    "views": {"count": 4, "width": 96, "height": 64},
    "init_points": 64}},
    "traffic": {"warmup_steps": 1, "traced_steps": 2}}

CELLS = ("dtu.step_late", "tnt.step_late")
SEED = 2_147_483_659        # above 2**31, as the driver's seeds may be
