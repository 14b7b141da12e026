"""Job runners: training spans and evaluation over an object store."""
