"""Architecture configs of the port (copies of ``repro/configs``).  Only
granite-3-2b is here so far; the registry names what brings the rest."""
