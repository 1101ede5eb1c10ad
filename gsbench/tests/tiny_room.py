"""The room cell cut to a size the CPU tests hold: 3,000 Gaussians in
4,096 slots, in the cell's proportions (shell 1,500, furniture 1,500), ten
96x64 views (eight train), one warm-up step, two traced steps."""

CELL = "scannetpp.step_late"
TINY = {"config": {"tpu": {"capacity": 4096}, "bench": {
    "room": {"shell": {"count": 1500}, "furniture": {"count": 1500}},
    "population": {"count": 3000, "capacity": 4096},
    "views": {"count": 10, "width": 96, "height": 64},
    "init_points": 64}},
    "traffic": {"warmup_steps": 1, "traced_steps": 2}}
