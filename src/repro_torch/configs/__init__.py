"""Architecture configs of the port (copies of ``repro/configs``):
granite-3-2b and deepseek-v2-lite-16b so far; the registry names what
brings the rest."""
