"""The general drivers a traffic mix names (``"driver"``)."""
