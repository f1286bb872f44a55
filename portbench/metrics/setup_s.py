"""Seconds from the process's start to the window's opening: the torch
import, the kernel library loaded (built on a checkout's first run), the
graph drawn, the program's database and tries built, and one query of
each shape of the mix run to warm the plans, tables and allocator."""


def read(w):
    return w.setup_s
