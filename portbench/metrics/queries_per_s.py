"""Queries answered over the window's seconds (in a static cell a query
is one count pass).  The window opens after set-up and closes when the
last query submitted in it has returned, so the rate takes all the work
of the window and all its time."""


def read(w):
    return len(w.ok()) / w.window_s if w.window_s > 0 else None
