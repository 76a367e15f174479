"""The plain reference of the RK4 configuration (``configs/bl3_rk4.toml``):
the frozen reference (``benchmark/reference/``) with classical RK4 in place
of Matsuno, and the counts of the RK4 stage kernel and step."""
