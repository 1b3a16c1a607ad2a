"""Runtime control plane of the port (the serving half of the JAX
package's ``runtime/``)."""
