"""Training: the cross-entropy loss (:mod:`.loss`), the synchronous step
(:mod:`.step`) and the paper's pod-consensus trainer (:mod:`.consensus`),
on dicts of tensors."""
