"""The parts of the JAX package's ``lint/`` that the serving stack reads at
run time: the lock annotations and hierarchy (:mod:`.concurrency`) and the
warmup grid (:mod:`.budget`).  The static analyzers stay in the JAX
package (ROADMAP item 13)."""
