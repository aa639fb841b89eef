"""One module per loop that drives the program (`fit`, `evaluate`,
`parallel_wrapper`), named by a traffic file's "loop" key. Each has
`run(session)`, which returns the run's measurements, and `control`."""
