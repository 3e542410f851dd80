"""Tokens generated by the window's waves over the window's seconds
(host clock): every served token counts, the last wave's included."""


def read(run):
    served = sum(len(o) - len(p) for w in run.waves
                 for p, o in zip(w.prompts, w.outputs))
    return served / run.window_s
