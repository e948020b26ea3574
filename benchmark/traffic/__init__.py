"""The benchmark's traffic: the utterance bank and the mixtures made from
it, drawn from the run's seed."""
