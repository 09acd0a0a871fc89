"""Training-step utilities (counterpart of pcseqlearning_tpu.parallel). One
card, no process group; the data-parallel step and the sharded proposal
wait for ROADMAP.md, queue 1 item 3."""
