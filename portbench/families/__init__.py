"""One module per model family: how a configuration file becomes the
port's network, its parameters in the port's trees, and its plain
reference. The harness finds a configuration's family by the
configuration's "family" key."""
