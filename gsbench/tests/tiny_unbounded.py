"""The unbounded cell cut to a size the CPU tests hold: 3,000 Gaussians in
4,096 slots, in the cell's proportions (object 500, ground 1,000,
surroundings 1,500), eight 96x64 views (seven train), one warm-up step,
two traced steps."""

CELL = "m360.step_late"
TINY = {"config": {"tpu": {"capacity": 4096}, "bench": {
    "population": {"count": 3000, "capacity": 4096,
                   "ground": {"count": 1000},
                   "background": {"count": 1500}},
    "views": {"count": 8, "width": 96, "height": 64},
    "init_points": 64}},
    "traffic": {"warmup_steps": 1, "traced_steps": 2}}
