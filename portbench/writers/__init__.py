"""Package writers that a configuration names by ``"writer": "<name>"``:
``portbench/writers/<name>.py`` defines ``write_package(root, cfg, gen,
device, settings)``.  A configuration without the key is written by
``portbench.writer.write_package``."""
