"""``final_s``: window seconds over the requests completed in the window
(one ``extend`` and one ``posterior(state).final()`` each). The window closes
once the last request started before ``--seconds`` has been answered."""


def read(run):
    return run.window_s / run.completed if run.completed else None
