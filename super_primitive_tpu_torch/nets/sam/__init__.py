"""SAM point-prompt selection on the device."""
