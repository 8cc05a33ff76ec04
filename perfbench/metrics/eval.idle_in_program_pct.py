"""eval.idle_in_program_pct: the share of the traced slice of eval tiles in
which the device was idle while the host was inside the program's
`infer.predict` span (numpy tile in to labels on the host), in %; the rest
of eval.idle_pct is the client's round trip between calls."""

from perfbench.work import spans


def read(ctx):
    return spans.idle_pct(ctx, 'infer.predict')
