"""Grid points advanced a second and chip over the whole window, in
millions: nx*ny*nz times the window's steps over its wall time, over the
cell's chips. It does not depend on dt."""


def read(run: dict):
    nx, ny, nz = run["grid"]
    return nx * ny * nz * run["steps"] / run["wall_s"] / run["chips"] / 1e6
