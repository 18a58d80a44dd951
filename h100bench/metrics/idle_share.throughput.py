"""Device: the share of the profiled stretch in which no kernel or copy ran,
in %, in the cells that report `output_tok_s`."""

from h100bench.trace import idle_share as read  # noqa: F401
