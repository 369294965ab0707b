"""A fault every MP-RGL driver's timed path can have: the planner's action
negated where ``predict`` returns it."""


def flip_decisions(mp):
    from relationalgraphlearning_tpu_torch.policies.model_predictive_rl \
        import ModelPredictiveRLPolicy
    orig = ModelPredictiveRLPolicy.predict

    def predict(self, js, *a, **kw):
        return -orig(self, js, *a, **kw)
    mp.setattr(ModelPredictiveRLPolicy, "predict", predict)
