"""A frozen copy of the port's plain paths (see ``reference/__init__``)."""
