"""docs_per_s: every document classified in the window over the window's
seconds (host clock; each request ends with its answers on the host)."""


def read(run):
    return run.window["docs"] / run.window["seconds"]
