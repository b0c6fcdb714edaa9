"""train_docs_per_s: the documents of every training step in the window
over the window's seconds (host clock; each step ends with its loss on the
host)."""


def read(run):
    return run.window["docs"] / run.window["seconds"]
