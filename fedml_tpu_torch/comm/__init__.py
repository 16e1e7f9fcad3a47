"""Communication plane: the update codec (``codec``)."""
