"""Share of the enhance cells' traced unit in which no kernel, copy or set ran
on the card (``readers.idle``)."""

from portbench.harness.readers import idle as read  # noqa: F401
