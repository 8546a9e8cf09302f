"""The loops the timed window drives, one module an entry kind."""
