"""docs_per_s.harvest: every document harvested in the window over the
window's seconds (host clock; each harvest ends with its store on the
host)."""


def read(run):
    return run.window["docs"] / run.window["seconds"]
