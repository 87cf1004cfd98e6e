"""serve: one book handed to ``serve.BookQueue.run`` (manifest, events,
pipeline construction, ``process()``, close), one span a book."""
TARGET = "synapta_tpu_torch.serve:BookQueue.run"


def attrs(args, kwargs, result):
    jobs = args[0].jobs
    return {"books": len(jobs), "done": sum(j.status == "done" for j in jobs),
            "pages": sum(j.pages for j in jobs)}
